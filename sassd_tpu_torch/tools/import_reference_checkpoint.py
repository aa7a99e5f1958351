"""Convert a reference SA-SSD torch checkpoint into a port checkpoint.

    python -m sassd_tpu_torch.tools.import_reference_checkpoint \
        ref.pth configs/car.py out.pt

Reads a ``.pth`` holding the reference model's ``state_dict`` (raw or
under a ``state_dict`` key, with or without DDP ``module.`` prefixes;
loaded with ``weights_only=False``, as the reference's files carry
training metadata, so convert only files you trust) and writes a port
checkpoint (train/checkpoint.py) with no optimizer state, which
``tools.test`` and ``tools.train --load_from`` read.

The name and axis mapping (:func:`convert`, numpy only) is the JAX
package's ``tools/import_reference_checkpoint.py``'s, kept here as a copy
so the port imports nothing of that package: the reference's
``neck.backbone.*`` (spconv ``[kz, ky, kx, Cin, Cout]`` weights, flattened
row-major to ``[27, Cin, Cout]``) -> ``vxnet``; ``neck.fcn.*`` (torch
``[Cout, Cin, kh, kw]`` -> ``[kh, kw, Cin, Cout]``) -> ``bevnet``;
``neck.point_fc/point_cls/point_reg`` (``[out, in]`` -> ``[in, out]``) ->
``aux``; ``bbox_head.conv_{cls,box,dir_cls}`` -> ``head.conv_{cls,box,
dir}``; ``extra_head.convs.{0,1,3}`` -> ``pswarp``; BatchNorm
``weight/bias`` -> ``scale/bias``, ``running_mean/var`` -> ``mean/var``,
``num_batches_tracked`` dropped. The shapes are checked by a strict
``load_state_dict`` into ``Detector(cfg)``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def _spconv_w(t: np.ndarray) -> np.ndarray:
    """[kz,ky,kx,Ci,Co] -> [K,Ci,Co] (row-major tap order matches ours)."""
    if t.ndim != 5:
        raise ValueError(f"expected 5D spconv weight, got {t.shape}")
    return np.ascontiguousarray(t.reshape(-1, t.shape[3], t.shape[4]))


def _conv2d_w(t: np.ndarray) -> np.ndarray:
    """torch [Co,Ci,kh,kw] -> [kh,kw,Ci,Co]."""
    if t.ndim != 4:
        raise ValueError(f"expected 4D conv weight, got {t.shape}")
    return np.ascontiguousarray(t.transpose(2, 3, 1, 0))


def _linear_w(t: np.ndarray) -> np.ndarray:
    """torch [out,in] -> [in,out]."""
    return np.ascontiguousarray(t.T)


def _vxnet_entries():
    """(ref_prefix, seq_idx_per_conv, our_block) for every VxNet block."""
    return [
        ("neck.backbone.conv0", (0, 3), "conv0"),
        ("neck.backbone.down0", (0,), "down0"),
        ("neck.backbone.conv1", (0, 3), "conv1"),
        ("neck.backbone.down1", (0,), "down1"),
        ("neck.backbone.conv2", (0, 3, 6), "conv2"),
        ("neck.backbone.down2", (0,), "down2"),
        ("neck.backbone.conv3", (0, 3, 6), "conv3"),
    ]


def convert(sd: dict) -> tuple[dict, dict, list]:
    """Torch state_dict (name -> np.ndarray) -> (params, state, unused)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    used = set()

    def take(name):
        if name not in sd:
            raise KeyError(f"reference checkpoint is missing '{name}'")
        used.add(name)
        return np.asarray(sd[name], dtype=np.float32)

    def bn(prefix):
        p = {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}
        s = {"mean": take(f"{prefix}.running_mean"),
             "var": take(f"{prefix}.running_var")}
        if f"{prefix}.num_batches_tracked" in sd:
            used.add(f"{prefix}.num_batches_tracked")
        return p, s

    params, state = {}, {}

    # ---- VxNet sparse ladder -------------------------------------------
    vx_p, vx_s = {}, {}
    for ref, idxs, ours in _vxnet_entries():
        bp, bs = {}, {}
        for i, j in enumerate(idxs):
            bp[f"conv{i}"] = {"w": _spconv_w(take(f"{ref}.{j}.weight"))}
            bp[f"bn{i}"], bs[f"bn{i}"] = bn(f"{ref}.{j + 1}")
        vx_p[ours], vx_s[ours] = bp, bs
    w = take("neck.backbone.extra_conv.0.weight")  # [1,1,1,64,64]
    vx_p["extra"] = {"conv0": {"w": np.ascontiguousarray(
        w.reshape(w.shape[3], w.shape[4]))}}
    vx_p["extra"]["bn0"], ebs = bn("neck.backbone.extra_conv.1")
    vx_s["extra"] = {"bn0": ebs}
    params["vxnet"], state["vxnet"] = vx_p, vx_s

    # ---- BEVNet dense trunk --------------------------------------------
    bev_p, bev_s = {}, {}
    for i in range(8):
        bev_p[f"conv{i}"] = {"w": _conv2d_w(take(f"neck.fcn.conv{i}.weight"))}
        bev_p[f"bn{i}"], bev_s[f"bn{i}"] = bn(f"neck.fcn.bn{i}")
    params["bevnet"], state["bevnet"] = bev_p, bev_s

    # ---- SSD rotate head -----------------------------------------------
    params["head"] = {
        "conv_cls": {"w": _conv2d_w(take("bbox_head.conv_cls.weight")),
                     "b": take("bbox_head.conv_cls.bias")},
        "conv_box": {"w": _conv2d_w(take("bbox_head.conv_box.weight")),
                     "b": take("bbox_head.conv_box.bias")},
        "conv_dir": {"w": _conv2d_w(take("bbox_head.conv_dir_cls.weight")),
                     "b": take("bbox_head.conv_dir_cls.bias")},
    }

    # ---- PSWarp head ----------------------------------------------------
    psw = {"conv0": {"w": _conv2d_w(take("extra_head.convs.0.weight"))},
           "conv1": {"w": _conv2d_w(take("extra_head.convs.3.weight"))}}
    psw["bn0"], psw_bn_s = bn("extra_head.convs.1")
    params["pswarp"], state["pswarp"] = psw, {"bn0": psw_bn_s}

    # ---- aux point branch ----------------------------------------------
    params["aux"] = {
        "point_fc": {"w": _linear_w(take("neck.point_fc.weight"))},
        "point_cls": {"w": _linear_w(take("neck.point_cls.weight"))},
        "point_reg": {"w": _linear_w(take("neck.point_reg.weight"))},
    }

    unused = sorted(set(sd) - used)
    return params, state, unused


def to_detector(params: dict, state: dict, cfg):
    """A Detector(cfg) holding the converted weights; raises when a name
    or a shape does not fit the model (a strict load_state_dict)."""
    import torch
    from sassd_tpu_torch.models.detector import Detector
    from sassd_tpu_torch.weights import _flatten

    flat = _flatten(params)
    flat.update(_flatten(state))
    model = Detector(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()},
                          strict=True)
    return model


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="reference .pth -> port .pt")
    ap.add_argument("torch_checkpoint", help=".pth file (state_dict)")
    ap.add_argument("config", help="config file (shape check)")
    ap.add_argument("out", help="output .pt checkpoint path")
    args = ap.parse_args(argv)

    import torch
    from sassd_tpu_torch.config import load_config
    from sassd_tpu_torch.train import checkpoint as ckpt

    blob = torch.load(args.torch_checkpoint, map_location="cpu",
                      weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}
    params, state, unused = convert(sd)
    model = to_detector(params, state, load_config(args.config))
    meta = blob if isinstance(blob, dict) else {}
    ckpt.write(args.out, model, None, int(meta.get("epoch", 0)),
               int(meta.get("it", 0)))
    print(f"wrote {args.out}")
    if unused:
        print(f"ignored {len(unused)} reference entries (legacy/aux): "
              + ", ".join(unused[:8]) + ("..." if len(unused) > 8 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
