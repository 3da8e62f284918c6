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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("with_x,with_state", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_scan_reference_matches_jax_kernel(with_x, with_state):
    t = 3
    args = _setup(t=t, with_x=with_x, with_state=with_state)
    with jax.default_matmul_precision("highest"):
        j_seq, (j_h, j_c) = jax_scan_fused(
            *[None if a is None else jnp.asarray(a) for a in args], seq_len=t, interpret=True)
    seq, (h, c) = convlstm.convlstm_scan_reference(*_torch(args), seq_len=t)
    assert seq.shape == (t, 2, 8, 8, 4)
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
