"""The bfloat16 sparse convs' operands as the card's wrappers prepare them:
K4-bf16 and K10-bf16 read the features (or output gradients) and the
weight rounded to bfloat16 once a call, before the gather, where the JAX
package rounds after it. On tiny_config() plans:

- ``bf16_panel``, the plain version of K4-bf16's weight operand (a
  forward's weight, and a submanifold conv's input-gradient weight: taps
  reversed, each tap transposed, zero columns up to 16), put back in
  channel order, is bitwise JAX's rounded weight matrix of the same conv,
  with zeros in its padding;
- the plain versions fed the pre-rounded operands (round, then gather:
  what the kernels read) are bitwise the same products of operands
  gathered, then rounded (JAX's order), and each lies within 1e-5 of the
  largest magnitude of JAX's ``_subm_conv_raw``, ``_subm_conv_sym_bwd``
  and ``_stride_hostT_bwd`` with compute_dtype=bfloat16 (float32 sums in
  another order), for subm and stride convs, input gradients on the
  subm plan and the transpose plan, and weight gradients.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from sassd_tpu.ops import sparse as jsp  # noqa: E402
from sassd_tpu_torch import config  # noqa: E402
from sassd_tpu_torch.data import synthetic  # noqa: E402
from sassd_tpu_torch.ops import sparse as sp  # noqa: E402

BF16 = torch.bfloat16
SPARSE_RTOL = 1e-5
# the sparse ladder's (Cin, Cout) pairs
LADDER = [(4, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64)]


def unpanel(panel):
    """bf16_panel's [27, N, Kp] back to [27, Kp, N] in channel order."""
    taps, n, kp = panel.shape
    return (panel.reshape(taps, n, kp // 16, 4, 2, 2)
            .permute(0, 2, 4, 3, 5, 1).reshape(taps, kp, n))


def bits(x):
    return np.asarray(x).view(np.uint16)


def jax_bf16(x):
    """A JAX bfloat16 array as a torch bfloat16 tensor (same bits)."""
    return torch.from_numpy(bits(x).astype(np.int16)).view(BF16)


def weight(rng, cin, cout):
    return (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)


@pytest.mark.parametrize("role", ["forward", "input_grad"])
@pytest.mark.parametrize("cin,cout", LADDER)
def test_bf16_panel_is_jax_weight(cin, cout, role):
    """The panel, put back in channel order, holds JAX's rounded weight
    matrix bit for bit, and zeros past its channels and columns."""
    w = weight(np.random.default_rng(cin * cout), cin, cout)
    jw = jnp.asarray(w)
    if role == "forward":
        panel = sp.bf16_panel(torch.from_numpy(w))
        want = jw.reshape(27 * cin, cout).astype(jnp.bfloat16).reshape(
            27, cin, cout)
    else:
        # as K4-bf16 reads it: the transposed view, taps reversed, the
        # columns zero-padded to 16 (the 4-wide input's gradient)
        panel = sp.bf16_panel(torch.from_numpy(w).transpose(1, 2),
                              max(cin, 16), taps_reversed=True)
        want = jw[::-1].transpose(0, 2, 1).reshape(27 * cout, cin).astype(
            jnp.bfloat16).reshape(27, cout, cin)
    k, n = want.shape[1:]
    assert panel.dtype == BF16 and panel.is_contiguous()
    assert panel.shape == (27, max(n, 16), -(-k // 16) * 16)
    got = unpanel(panel)
    assert torch.equal(got[:, :k, :n].view(torch.int16),
                       jax_bf16(want).view(torch.int16))
    assert not got[:, k:].float().any() and not got[:, :, n:].float().any()


@pytest.fixture(scope="module")
def tiny_plans():
    cfg = config.tiny_config()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(4),
                                        batch_size=2, n_points=900)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    return batch, caps


def jflat(plan, rows_in):
    """A wire plan [B, 27, M] as the JAX package's flat SubmPlan."""
    p = jnp.asarray(plan)
    return jsp.flatten_plan(jsp.SubmPlan(jnp.maximum(p, 0).astype(
        jnp.int32), p >= 0), rows_in)


def gathered_then_rounded(x, plan):
    """The im2col of float32 rows, then rounded (JAX's order)."""
    b, m_in, c = x.shape
    col = sp.gather_im2col(x.reshape(b * m_in, c),
                           sp.flatten_plan(sp.host_plan(plan), m_in))
    return col.to(BF16).float()


def err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# (what, plan level, Cin, Cout): the forward on subm and stride plans
# (Cin 4: the mean VFE's input), the input gradient on the subm plan and
# on the stride conv's transpose plan, and the weight gradient
CASES = [("subm", 0, 4, 16), ("subm", 1, 32, 32), ("stride", 2, 32, 64),
         ("subm_dx", 0, 16, 16), ("subm_dx", 2, 64, 64),
         ("strideT_dx", 1, 16, 32), ("strideT_dx", 3, 64, 64),
         ("subm_dw", 0, 4, 16), ("subm_dw", 1, 32, 32),
         ("stride_dw", 2, 32, 64)]


@pytest.mark.parametrize("what,level,cin,cout", CASES)
def test_prerounded_operands_match_jax(tiny_plans, what, level, cin, cout):
    batch, caps = tiny_plans
    rng = np.random.default_rng(level + cin + cout + len(what))
    stride = what.startswith("stride")
    plan = batch[f"plan_{'stride' if stride else 'subm'}{level}"]
    m_in = caps[level - 1] if stride else caps[level]
    m_out = plan.shape[2]
    x = rng.normal(size=(2, m_in, cin)).astype(np.float32)
    w = weight(rng, cin, cout)
    cot = rng.normal(size=(2, m_out, cout)).astype(np.float32)
    tx, tw, tc, tp = (torch.from_numpy(a) for a in (x, w, cot, plan))
    jx, jc = (jnp.asarray(a.reshape(-1, a.shape[-1])) for a in (x, cot))
    jw = jnp.asarray(w)
    jplan = jflat(plan, m_in)
    if what in ("subm", "stride"):
        # K4-bf16's operands: the rounded copy and the panel
        pre = sp.subm_conv_batched_plain(
            tx.to(BF16).float(), unpanel(sp.bf16_panel(tw))[:, :cin].float(),
            tp)
        late = gathered_then_rounded(tx, tp) @ tw.to(BF16).float().reshape(
            27 * cin, cout)
        ref = jsp._subm_conv_raw(jx, jw, jplan, jnp.bfloat16)
        pre = pre.reshape(-1, cout)
    elif what.endswith("_dx"):
        res = (None, jx, jw, jplan.idx, jplan.found)
        if what == "subm_dx":
            w_dx, dx_plan = sp.input_grad_weight(tw), tp
            panel = sp.bf16_panel(tw.transpose(1, 2), max(cin, 16),
                                  taps_reversed=True)
            ref = jsp._subm_conv_sym_bwd(jnp.bfloat16, False, False, res,
                                         jc)[0]
        else:
            plan_t = batch[f"plan_strideT{level}"]
            w_dx, dx_plan = tw.transpose(1, 2), torch.from_numpy(plan_t)
            panel = sp.bf16_panel(w_dx)
            jt = jflat(plan_t, m_out)
            ref = jsp._stride_hostT_bwd(jnp.bfloat16, False, False,
                                        res + (jt.idx, jt.found), jc)[0]
        ncol = w_dx.shape[2]
        pre = sp.subm_conv_batched_plain(
            tc.to(BF16).float(), unpanel(panel)[:, :cout].float(),
            dx_plan).reshape(-1, ncol)[:, :cin]
        late = (gathered_then_rounded(tc, dx_plan)
                @ w_dx.to(BF16).float().reshape(27 * cout, ncol))[:, :cin]
    else:
        pre = sp.conv_weight_grad_plain(tx.to(BF16).float(), tp,
                                        tc.to(BF16).float())
        late = (gathered_then_rounded(tx, tp).T
                @ tc.to(BF16).float().reshape(-1, cout)).reshape(27, cin, cout)
        res = (None, jx, jw, jplan.idx, jplan.found)
        if stride:
            jt = jflat(batch[f"plan_strideT{level}"], m_out)
            res += (jt.idx, jt.found)
            ref = jsp._stride_hostT_bwd(jnp.bfloat16, False, False, res,
                                        jc)[1]
        else:
            ref = jsp._subm_conv_sym_bwd(jnp.bfloat16, False, False, res,
                                         jc)[1]
    assert torch.equal(pre.view(torch.int32), late.view(torch.int32))
    assert err(pre, ref) <= SPARSE_RTOL
    assert np.abs(np.asarray(ref)).max() > 0.1
