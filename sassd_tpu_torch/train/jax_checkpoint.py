"""Reader of the checkpoint files the JAX package writes.

A JAX checkpoint (``sassd_tpu/train/checkpoint.py``) is one flax
``msgpack_serialize`` map ``{params, state, opt_state, epoch, step,
batch_idx}``: nested maps with string keys, integers, and arrays as
msgpack extension type 1, whose payload is itself msgpack of ``(shape,
dtype name, the C-order bytes)`` (numpy scalars: type 3, the same
payload). This module decodes that subset of msgpack in pure Python, so
reading such a file does not depend on the ``msgpack`` package. Anything
outside the subset raises ValueError rather than being misread: other
extension types, flax's chunked form of arrays over its chunk size, and
dtypes other than bool, integers and IEEE floats (bfloat16, complex).

The optimizer state is optax's: the JAX package's train loop builds
``chain(clip_by_global_norm, inject_hyperparams(adamw | sgd)(...))``
(``sassd_tpu/train/optim.py``), whose state dict is
``{"0": clip (empty), "1": {count, hyperparams, [hyperparams_states],
inner_state: {"0": scale_by_adam's {count, mu, nu} | trace's {trace},
...}}}``. :func:`optimizer_state` maps it onto the port's optimizers
(train/optim.py) by the parameter names of ``weights.py``.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

from sassd_tpu_torch.weights import _flatten

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one bytes object."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("b"), n)
        if 0xD4 <= b <= 0xD8:                  # fixext 1, 2, 4, 8, 16
            return self.ext(self.unpack("b"), 1 << (b - 0xD4))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1} "
                         f"is not one of this reader's")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:
            raise ValueError("flax's chunked array form is not supported")
        return out

    def ext(self, code: int, n: int) -> np.ndarray:
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not an array")
        arr = _ndarray(payload)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _ndarray(payload: bytes) -> np.ndarray:
    tpl = loads(payload)
    if not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError("an array payload is not (shape, dtype, bytes)")
    shape, name, buf = tpl
    if isinstance(name, bytes):
        name = name.decode("utf-8")
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"array dtype {name!r} is not supported") from e
    if dtype.kind not in "biuf":          # bool, ints, IEEE floats
        raise ValueError(f"array dtype {name!r} is not supported")
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def loads(data: bytes) -> Any:
    """Decode one msgpack value of the subset (the whole of `data`)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack value")
    return out


def read(path: str) -> Dict[str, Any]:
    """A JAX checkpoint file as nested dicts of numpy arrays and ints."""
    with open(path, "rb") as f:
        payload = loads(f.read())
    if not (isinstance(payload, dict)
            and {"params", "state", "epoch", "step"} <= set(payload)):
        raise ValueError(f"{path} is not a JAX checkpoint")
    return payload


def optimizer_state(opt_state: dict) -> Dict[str, Any]:
    """optax's state dict -> the port optimizer's state: ``{count, mu,
    nu}`` for the AdamW kinds (scale_by_adam's count, the one its bias
    correction reads), ``{count, trace}`` for sgd (inject_hyperparams'
    count), each moment keyed by parameter name. Raises ValueError when
    the state has neither layout (an imported reference checkpoint holds
    none: ``opt_state={}``)."""
    try:
        injected = opt_state["1"]
        inner = injected["inner_state"]["0"]
    except (KeyError, TypeError):
        raise ValueError("the checkpoint holds no optax state of "
                         "chain(clip, inject_hyperparams(...))") from None
    if "mu" in inner and "nu" in inner:
        return dict(count=int(inner["count"]), mu=_flatten(inner["mu"]),
                    nu=_flatten(inner["nu"]))
    if "trace" in inner:
        return dict(count=int(injected["count"]),
                    trace=_flatten(inner["trace"]))
    raise ValueError(f"unknown optax inner state {sorted(inner)}")

