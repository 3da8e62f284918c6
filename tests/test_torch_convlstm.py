r"""The port's whole-recurrence ConvLSTM scan against the JAX package's.

``vp_suite_tpu_torch.ops.convlstm.convlstm_scan_reference`` (what the port's
``convlstm_scan_fused`` computes on CPU tensors, and what its CUDA kernel is
held against on the card) must match the JAX Pallas scan kernel, run here in
interpret mode, in decode and input-driven modes, from zero and from given
states: f32, atol 2e-5 on h_seq, h_last and c_last. Under autograd, the
port's ``convlstm_scan_fused`` (on the CPU: the plain forward with its
residuals, ``convlstm_scan_backward_reference`` and the bulk weight, bias
and peephole contractions) must give ``jax.grad`` of the JAX kernel's custom
VJP for all eight inputs, at sh != sw: rtol and atol 2e-4.

In bf16 the gradient of ``h_last`` must enter the backward's f32 ``dh``
carry apart from ``dh_seq``, as in the JAX kernel: the port's scan backward
against JAX's ``_scan_fused_bwd`` (interpret mode) on the same bf16 residuals
and cotangents, and all eight gradients of a loss over ``h_seq`` and
``h_last`` against ``jax.grad``, each within 5e-4 in relative L2 norm. Adding
the two cotangents in bf16 first, as autograd does when ``h_last`` is a view
of ``h_seq``, rounds about half of those sums and gives 1.4e-3 to 3.4e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp_suite_tpu.ops.pallas_convlstm import _scan_fused_bwd as jax_scan_fused_bwd
from vp_suite_tpu.ops.pallas_convlstm import convlstm_scan_fused as jax_scan_fused
from vp_suite_tpu_torch.ops import convlstm

torch.set_num_threads(1)


def _setup(t=3, b=2, sh=8, sw=8, enc=4, with_x=True, with_state=False, seed=0):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    if with_state:
        h0 = (rng.randn(b, sh, sw, enc) * 0.3).astype(f32)
        c0 = (rng.randn(b, sh, sw, enc) * 0.3).astype(f32)
    else:
        h0 = np.zeros((b, sh, sw, enc), f32)
        c0 = np.zeros_like(h0)
    h_kernel = (rng.randn(3, 3, enc, 4 * enc) * 0.3).astype(f32)
    bias = (rng.randn(4 * enc) * 0.1).astype(f32)
    wci, wcf, wco = ((rng.randn(sh, sw, enc) * 0.1).astype(f32) for _ in range(3))
    i2h = (rng.randn(t, b, sh, sw, 4 * enc) * 0.3).astype(f32) if with_x else None
    return [i2h, h0, c0, h_kernel, bias, wci, wcf, wco]


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


#: (with_x, with_state, (sh, sw, enc)): every mode at 8x8x4, and at 6x10x16 (sh != sw and
#: enc=16, the narrowest the port's bf16 kernel takes, whose h stages are half full).
SCAN_CASES = [pytest.param(x, s, (8, 8, 4), id=f"{x}-{s}")
              for x, s in ((False, False), (True, False), (False, True), (True, True))] \
    + [pytest.param(x, s, (6, 10, 16), id=f"{x}-{s}-6x10x16")
       for x, s in ((False, False), (True, False), (False, True), (True, True))]


@pytest.mark.parametrize("with_x,with_state,shape", SCAN_CASES)
def test_scan_reference_matches_jax_kernel(with_x, with_state, shape):
    t = 3
    sh, sw, enc = shape
    args = _setup(t=t, sh=sh, sw=sw, enc=enc, with_x=with_x, with_state=with_state)
    with jax.default_matmul_precision("highest"):
        j_seq, (j_h, j_c) = jax_scan_fused(
            *[None if a is None else jnp.asarray(a) for a in args], seq_len=t, interpret=True)
    seq, (h, c) = convlstm.convlstm_scan_reference(*_torch(args), seq_len=t)
    assert seq.shape == (t, 2, sh, sw, enc)
    for ours, theirs in ((seq, j_seq), (h, j_h), (c, j_c)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=2e-5)


def test_scan_reference_bf16_carry_rules():
    r"""bf16 activations: h is rounded to bf16 every step while the cell
    carry stays f32, as in the JAX kernel (interpret mode); outputs agree to
    a few bf16 ulps after 3 steps."""
    t = 3
    args = _setup(t=t, with_x=True, with_state=True, seed=3)
    bf = [None if a is None else jnp.asarray(a, jnp.bfloat16) for a in args]
    bf[4] = jnp.asarray(args[4])  # the bias stays f32 in the kernel
    j_seq, (j_h, j_c) = jax_scan_fused(*bf, seq_len=t, interpret=True)
    targs = [None if a is None else torch.from_numpy(a).bfloat16() for a in args]
    targs[4] = torch.from_numpy(args[4])
    seq, (h, c) = convlstm.convlstm_scan_reference(*targs, seq_len=t)
    assert seq.dtype == h.dtype == c.dtype == torch.bfloat16
    for ours, theirs in ((seq, j_seq), (h, j_h), (c, j_c)):
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)),
                                   rtol=0, atol=3e-2)


def test_scan_fused_on_cpu_is_the_reference():
    args = _torch(_setup(t=2, with_x=True, with_state=True, seed=1))
    before = convlstm.convlstm_scan_fused.launches
    seq, (h, c) = convlstm.convlstm_scan_fused(*args, seq_len=2)
    rseq, (rh, rc) = convlstm.convlstm_scan_reference(*args, seq_len=2)
    assert torch.equal(seq, rseq) and torch.equal(h, rh) and torch.equal(c, rc)
    assert convlstm.convlstm_scan_fused.launches == before


def test_scan_rejects_bad_input():
    args = _torch(_setup(t=2))
    with pytest.raises(ValueError):   # i2h_t covers 2 steps, not 3
        convlstm.convlstm_scan_fused(*args, seq_len=3)
    args[3] = args[3][:, :, :, :-1]
    with pytest.raises(ValueError):
        convlstm.convlstm_scan_fused(*args, seq_len=2)


@pytest.mark.parametrize("with_x,with_state", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_scan_grads_match_jax_kernel(with_x, with_state):
    t = 3
    args = _setup(t=t, sh=6, sw=10, with_x=with_x, with_state=with_state, seed=7)
    rng = np.random.RandomState(8)
    r_seq = rng.randn(t, 2, 6, 10, 4).astype(np.float32)
    argnums = tuple(j for j in range(8) if with_x or j != 0)

    def jax_loss(*a):
        seq, (h, c) = jax_scan_fused(*a, seq_len=t, interpret=True)
        return jnp.sum(seq * r_seq) + jnp.sum(h * c)

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jax_loss, argnums=argnums)(*[None if a is None else jnp.asarray(a)
                                                     for a in args])
    leaves = [None if a is None else a.requires_grad_() for a in _torch(args)]
    seq, (h, c) = convlstm.convlstm_scan_fused(*leaves, seq_len=t)
    got = torch.autograd.grad((seq * torch.from_numpy(r_seq)).sum() + (h * c).sum(),
                              [leaves[j] for j in argnums])
    names = ["i2h", "h0", "c0", "h_kernel", "bias", "wci", "wcf", "wco"]
    for j, g, w in zip(argnums, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=names[j])


def test_scan_backward_reference_is_the_transposed_walk():
    r"""The plain backward on the plain forward's residuals equals autograd of
    the plain forward in dz (through i2h), dh0 and dc0, at sh != sw with a
    weight that has no symmetry: a mirrored or unflipped tap fails."""
    t = 3
    args = _torch(_setup(t=t, sh=5, sw=9, with_x=True, with_state=True, seed=9))
    rng = np.random.RandomState(10)
    d_seq = torch.from_numpy(rng.randn(t, 2, 5, 9, 4).astype(np.float32))
    d_c = torch.from_numpy(rng.randn(2, 5, 9, 4).astype(np.float32))
    leaves = [a.clone().requires_grad_() for a in args[:3]]
    seq, c_last = convlstm.convlstm_scan_forward_reference(*leaves, *args[3:], seq_len=t)
    want = torch.autograd.grad((seq * d_seq).sum() + (c_last * d_c).sum(), leaves)
    _, _, z, c_prev = convlstm.convlstm_scan_forward_reference(*args, seq_len=t, save_gates=True)
    got = convlstm.convlstm_scan_backward_reference(z, c_prev, d_seq, d_c, args[3], *args[5:])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    assert convlstm.convlstm_scan_backward.launches == 0


#: bf16 against JAX, relative L2 norm of the error: both compute the same f32
#: formulas on the same bf16 values and round once (measured: 0 for dz, dh0
#: and dc0, up to 9e-6 for the gradients); folding dh_last into dh_seq in bf16
#: gives 1.4e-3 or more.
BF16_REL_L2 = 5e-4


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _jax_bf16(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def test_scan_backward_carries_dh_last_in_f32_as_jax():
    r"""dz, dh0 and dc0 of the port's bf16 scan backward with a nonzero
    dh_last against JAX's ``_scan_fused_bwd`` (which returns dh0 and dc0 in
    bf16: the port's f32 results are rounded once for the comparison)."""
    t, b, sh, sw, enc = 2, 2, 6, 10, 4
    rng = np.random.RandomState(11)
    z = _bf16(rng.randn(t, b, sh, sw, 4 * enc))
    c_prev = _bf16(rng.randn(t, b, sh, sw, enc) * 0.5)
    dh_seq = _bf16(rng.randn(t, b, sh, sw, enc))
    dh_last = _bf16(rng.randn(b, sh, sw, enc))
    dc_last = _bf16(rng.randn(b, sh, sw, enc))
    h_kernel = _bf16(rng.randn(3, 3, enc, 4 * enc) * 0.3)
    peep = [_bf16(rng.randn(sh, sw, enc) * 0.1) for _ in range(3)]
    h_seq, h0, c_last = (_bf16(rng.randn(*s)) for s in ((t, b, sh, sw, enc), (b, sh, sw, enc),
                                                         (b, sh, sw, enc)))
    total = dh_seq[-1].float() + dh_last.float()
    assert (total.bfloat16().float() != total).float().mean() > 0.3   # the bf16 sum rounds

    gates = _jax_bf16(z).reshape(t, b, sh * sw, 4, enc).transpose(0, 1, 3, 2, 4)
    res = (gates, _jax_bf16(c_prev).reshape(t, b, sh * sw, enc), _jax_bf16(h_seq), _jax_bf16(h0),
           _jax_bf16(c_last), _jax_bf16(h_kernel), jnp.zeros((4 * enc,), jnp.float32),
           *[_jax_bf16(p) for p in peep], True)
    out = jax_scan_fused_bwd(t, True, res, (_jax_bf16(dh_seq),
                                            (_jax_bf16(dh_last), _jax_bf16(dc_last))))
    want = [torch.from_numpy(np.array(o.astype(jnp.float32))) for o in out[:3]]   # d_i2h is dz
    got = convlstm.convlstm_scan_backward(z, c_prev, dh_seq, dc_last, h_kernel, *peep, dh_last)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    for name, g, w in zip(("dz", "dh0", "dc0"), got, want):
        assert g.shape == w.shape
        assert _rel_l2(g.bfloat16(), w) <= BF16_REL_L2, name
    assert convlstm.convlstm_scan_backward.launches == 0


def test_scan_fused_bf16_grads_with_h_last_match_jax():
    r"""All eight gradients of a bf16 loss over h_seq, h_last and c_last
    through ``convlstm_scan_fused`` against ``jax.grad`` of the JAX kernel's
    custom VJP (interpret mode)."""
    t, b, sh, sw, enc = 2, 2, 6, 10, 4
    rng = np.random.RandomState(12)
    f32 = np.float32
    args = [(rng.randn(t, b, sh, sw, 4 * enc) * 0.5).astype(f32),
            (rng.randn(b, sh, sw, enc) * 0.5).astype(f32), (rng.randn(b, sh, sw, enc) * 0.5).astype(f32),
            (rng.randn(3, 3, enc, 4 * enc) * 0.3).astype(f32), (rng.randn(4 * enc) * 0.1).astype(f32)] \
        + [(rng.randn(sh, sw, enc) * 0.1).astype(f32) for _ in range(3)]
    r_seq, r_h, r_c = (rng.randn(*s).astype(f32) for s in ((t, b, sh, sw, enc), (b, sh, sw, enc),
                                                         (b, sh, sw, enc)))

    def jax_loss(*a):
        seq, (h, c) = jax_scan_fused(*a, seq_len=t, interpret=True)
        return (jnp.sum(seq.astype(jnp.float32) * r_seq) + jnp.sum(h.astype(jnp.float32) * r_h)
                + jnp.sum(c.astype(jnp.float32) * r_c))

    want = jax.grad(jax_loss, argnums=tuple(range(8)))(
        *[jnp.asarray(a, jnp.float32 if i == 4 else jnp.bfloat16) for i, a in enumerate(args)])
    leaves = [torch.from_numpy(a).to(torch.float32 if i == 4 else torch.bfloat16).requires_grad_()
              for i, a in enumerate(args)]
    seq, (h, c) = convlstm.convlstm_scan_fused(*leaves, seq_len=t)
    loss = (seq.float() * torch.from_numpy(r_seq)).sum() + (h.float() * torch.from_numpy(r_h)).sum() \
        + (c.float() * torch.from_numpy(r_c)).sum()
    got = torch.autograd.grad(loss, leaves)
    names = ["i2h", "h0", "c0", "h_kernel", "bias", "wci", "wcf", "wco"]
    for name, g, w in zip(names, got, want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert g.dtype == (torch.float32 if name == "bias" else torch.bfloat16), name
        assert _rel_l2(g, w) <= BF16_REL_L2, name


def test_scan_backward_dh_last_none_is_zeros():
    args = _torch(_setup(t=2, sh=5, sw=7, with_x=True, with_state=True, seed=13))
    _, _, z, c_prev = convlstm.convlstm_scan_forward_reference(*args, seq_len=2, save_gates=True)
    rng = np.random.RandomState(14)
    d_seq = torch.from_numpy(rng.randn(2, 2, 5, 7, 4).astype(np.float32))
    d_c = torch.from_numpy(rng.randn(2, 5, 7, 4).astype(np.float32))
    bwd = (z, c_prev, d_seq, d_c, args[3], *args[5:])
    for g, w in zip(convlstm.convlstm_scan_backward(*bwd),
                    convlstm.convlstm_scan_backward(*bwd, dh_last=torch.zeros_like(d_c))):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="dh_last"):
        convlstm.convlstm_scan_backward(*bwd, dh_last=d_c[:, :-1])
