"""The port's flash-attention and SSD-scan entry points against the JAX
package on the CPU, where each port wrapper runs its plain PyTorch version
and the JAX kernels run in Pallas interpret mode (as tests/test_kernels.py
runs them).  Inputs are made with numpy from a seed and handed to both;
bf16 cases round the same f32 values to bf16 on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.flash_attention.kernel import \
    flash_attention_bhsd as jflash_bhsd
from repro.kernels.ssd_scan import ops as jssd_ops
from repro.kernels.ssd_scan.kernel import ssd_scan_grid as jssd_scan_grid
from repro.models import attention as jattn
from repro.models import mamba2 as jm2
from repro_torch import _build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2

# tests/test_kernels.py:15: f32 within 2e-5, bf16 within 2e-2
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    return (jnp.asarray(a, JDT[dtype]),
            torch.tensor(np.asarray(a)).to(TDT[dtype]))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- flash attention ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
    (1, 128, 2, 2, 64, True),
    (2, 256, 4, 2, 64, True),
    (1, 256, 4, 1, 128, True),      # strong GQA grouping
    (2, 128, 2, 2, 128, False),     # bidirectional (encoder)
    (1, 384, 6, 2, 64, True),       # non-power-of-two heads
])
def test_flash_attention_sweep_matches_jax(B, S, Hq, Hkv, D, causal, dtype):
    rng = np.random.default_rng(B * 1000 + S + Hq + D)
    qa = rng.standard_normal((B, S, Hq, D), np.float32)
    ka = rng.standard_normal((B, S, Hkv, D), np.float32)
    va = rng.standard_normal((B, S, Hkv, D), np.float32)
    (jq, q), (jk, k), (jv, v) = (_pair(a, dtype) for a in (qa, ka, va))
    n0 = _build.PLAIN_CALLS["flash_attention"]
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    assert _build.PLAIN_CALLS["flash_attention"] == n0 + 1
    assert out.dtype == TDT[dtype] and out.shape == q.shape
    pallas = jfa_ops.flash_attention(jq, jk, jv, causal=causal)
    ref = jfa_ref.attention_ref(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), causal).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", [
    (1, 200, 200, 4, 2, 80, True),    # zamba2's head dim, ragged S
    (2, 200, 200, 2, 2, 80, False),
    (1, 77, 77, 3, 1, 32, True),
    (1, 64, 130, 2, 2, 64, True),     # Sq != Sk: mask q_pos >= k_pos from 0
])
def test_flash_attention_ragged_and_head_dim_80(B, Sq, Sk, Hq, Hkv, D,
                                               causal):
    rng = np.random.default_rng(Sq + Sk + D)
    qa = rng.standard_normal((B, Hq, Sq, D), np.float32)
    ka = rng.standard_normal((B, Hkv, Sk, D), np.float32)
    va = rng.standard_normal((B, Hkv, Sk, D), np.float32)
    (jq, q), (jk, k), (jv, v) = (_pair(a) for a in (qa, ka, va))
    out = fa_kernel.flash_attention_bhsd(q, k, v, causal=causal)
    ref = jfa_ref.attention_ref(jq, jk, jv, causal)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])


def test_flash_attention_matches_model_chunked_path():
    """The kernel's entry point and the model's chunked path agree in the
    port, and the port's chunked path agrees with the JAX one."""
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 256, 4, 64
    arrs = [rng.standard_normal((B, S, H, D), np.float32) for _ in range(3)]
    (jq, q), (jk, k), (jv, v) = (_pair(a) for a in arrs)
    a = fa_ops.flash_attention(q, k, v, causal=True)
    b = attn.chunked_attention(q, k, v, causal=True, chunk_q=128,
                               chunk_k=128)
    j = jattn.chunked_attention(jq, jk, jv, causal=True, chunk_q=128,
                                chunk_k=128)
    np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(b), _np(j), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", [
    (1, 256, 256, 4, 2, 64, True),    # lengths the Pallas blocks divide
    (2, 128, 128, 2, 2, 80, True),    # zamba2's head dim
    (1, 128, 256, 4, 1, 80, False),   # Sq != Sk, bidirectional
])
def test_bf16_probability_rounding_stays_within_bf16_tolerance(
        B, Sq, Sk, Hq, Hkv, D, causal):
    """The CUDA bf16 path rounds P to bf16 before P.V, a step the Pallas
    kernel does not take.  Its plain emulation (online softmax over key
    tiles of 64, as the kernel) stays within the bf16 tolerance of the
    JAX kernel in interpret mode and of the JAX reference."""
    rng = np.random.default_rng(Sq + Sk + D + Hq)
    arrs = [rng.standard_normal((B, h, S, D), np.float32)
            for h, S in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk))]
    (jq, q), (jk, k), (jv, v) = (_pair(a, "bfloat16") for a in arrs)
    got = fa_ref.attention_bf16_probs_ref(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    pallas = jflash_bhsd(jq, jk, jv, causal=causal, interpret=True)
    ref = jfa_ref.attention_ref(jq, jk, jv, causal)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL["bfloat16"])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", [
    (1, 100, 100, 4, 2, 192, True),    # GQA 2, a length no tile divides
    (2, 77, 77, 4, 1, 256, False),     # GQA 4, bidirectional
])
def test_flash_attention_wide_heads_match_pallas(B, Sq, Sk, Hq, Hkv, D,
                                                 causal, dtype):
    """Head dims past 160, which the CUDA kernel walks in chunks and
    column slices: the port's entry point against the Pallas kernel in
    interpret mode and the JAX reference."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(Sq + D + Hq)
    arrs = [rng.standard_normal((B, h, S, D), np.float32)
            for h, S in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk))]
    (jq, q), (jk, k), (jv, v) = (_pair(a, dtype) for a in arrs)
    out = fa_kernel.flash_attention_bhsd(q, k, v, causal=causal)
    assert out.dtype == TDT[dtype] and out.shape == q.shape
    pallas = jflash_bhsd(jq, jk, jv, causal=causal, interpret=True)
    ref = jfa_ref.attention_ref(jq, jk, jv, causal)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


# shapes the Pallas kernel takes: past the old caps (head dims to 512,
# grids past 65,535 batches or query blocks) and the narrowest head
@pytest.mark.parametrize("q,k", [
    ((1, 8, 200, 176), (1, 2, 200, 176)), ((2, 4, 130, 200), (2, 2, 70, 200)),
    ((2, 16, 2048, 256), (2, 16, 2048, 256)), ((1, 4, 64, 512), (1, 1, 64, 512)),
    ((65536, 1, 8, 16), (65536, 1, 8, 16)),
    ((1, 2, 128 * 65536 + 1, 64), (1, 2, 64, 64)),
    ((1, 2, 64, 1), (1, 2, 64, 1))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_checks_take_the_pallas_domain(q, k, dtype):
    fa_kernel.check_args(q, k, k)
    fa_kernel.check_args(q, k, k, (dtype,) * 3)


@pytest.mark.parametrize("q,k,dtypes,err", [
    ((1, 3, 16, 256), (1, 2, 16, 256), None, ValueError),   # Hq % Hkv
    ((1, 4, 16, 64), (1, 2, 16, 32), None, ValueError),     # head dims
    ((1, 4, 16, 64), (1, 0, 16, 64), None, ValueError),     # no kv heads
    ((1, 4, 16, 64), (1, 2, 16, 64), (torch.float16,) * 3, TypeError),
    ((1, 4, 16, 64), (1, 2, 16, 64), (torch.float64,) * 3, TypeError),
    ((1, 4, 16, 64), (1, 2, 16, 64),
     (torch.float32, torch.bfloat16, torch.float32), TypeError)])
def test_flash_attention_checks_refuse_what_the_kernels_refuse(q, k, dtypes,
                                                              err):
    with pytest.raises(err):
        fa_kernel.check_args(q, k, k, dtypes)


def test_flash_attention_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 3, 16, 8)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_bhsd(q, torch.zeros(1, 2, 16, 8),
                                       torch.zeros(1, 2, 16, 8))
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_bhsd(q, torch.zeros(1, 3, 16, 4),
                                       torch.zeros(1, 3, 16, 4))


# -- ssd scan ----------------------------------------------------------------------

def _ssd_inputs(b, S, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, S, h, p), np.float32),
            (rng.standard_normal((b, S, h)) * 0.5).astype(np.float32),
            -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32),
            (rng.standard_normal((b, S, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, S, n)) * 0.3).astype(np.float32),
            rng.standard_normal(h).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,h,p,n,chunk", [
    (1, 128, 4, 32, 16, 32),
    (2, 256, 8, 64, 32, 64),
    (1, 256, 8, 64, 128, 128),   # mamba2-2.7b-like state width
    (2, 64, 2, 32, 16, 64),      # single chunk
])
def test_ssd_scan_sweep_matches_jax(b, S, h, p, n, chunk, dtype):
    xa, dta, Aa, Ba, Ca, Da = _ssd_inputs(b, S, h, p, n, seed=S + h + n)
    # x, dt, B, C in the case's dtype; A and D in f32 (test_kernels.py)
    (jx, x), (jdt, dt), (jB, B), (jC, C) = (
        _pair(a, dtype) for a in (xa, dta, Ba, Ca))
    (jA, A), (jD, D) = _pair(Aa), _pair(Da)
    n0 = _build.PLAIN_CALLS["ssd_scan"]
    y, st = ssd_ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    assert _build.PLAIN_CALLS["ssd_scan"] == n0 + 1
    assert y.dtype == TDT[dtype] and st.dtype == torch.float32
    jy_k, jst_k = jssd_ops.ssd_scan(jx, jdt, jA, jB, jC, jD, chunk=chunk)
    jy_r, jst_r = jm2.ssd_chunked_ref(jx, jdt, jA, jB, jC, jD, chunk)
    ry, rst = m2.ssd_chunked_ref(x, dt, A, B, C, D, chunk)
    st_tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else \
        TOL["float32"]
    for want_y, want_st in ((jy_k, jst_k), (jy_r, jst_r)):
        np.testing.assert_allclose(_np(y), _np(want_y), **TOL[dtype])
        np.testing.assert_allclose(_np(st), _np(want_st), **st_tol)
    np.testing.assert_allclose(_np(ry), _np(jy_r), **TOL[dtype])
    np.testing.assert_allclose(_np(rst), _np(jst_r), **st_tol)


# A chunk of 256 sums twice the products of one of 128 into each y, in
# f32 in another order on each side: on the first case below JAX's y is
# 3.2e-5 and the port's 4.0e-5 from a float64 evaluation of the same
# function, 7 of 65,536 values 5.4e-5 apart.  So y is held as the full
# prefill shapes are on the card (chip_smoke.py's SSD_TOL_FULL, 1e-4); the
# state, and every other value, within test_kernels.py's 2e-5.
SSD_TOL_CHUNK_256 = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,S,h,p,n,chunk,y_tol", [
    (1, 512, 2, 64, 128, 256, SSD_TOL_CHUNK_256),   # Mamba2's chunk
    (1, 256, 2, 128, 256, 128, TOL["float32"]),     # head dim 128, state 256
])
def test_ssd_scan_wide_tiles_match_jax(b, S, h, p, n, chunk, y_tol):
    """Chunks, head dims and states past one tile of the CUDA kernel: the
    port's entry point against JAX's `ssd_scan` (the Pallas grid in
    interpret mode) and `ssd_chunked_ref`."""
    torch.set_num_threads(1)
    xa, dta, Aa, Ba, Ca, Da = _ssd_inputs(b, S, h, p, n, seed=S + p + n)
    (jx, x), (jdt, dt), (jA, A), (jB, B), (jC, C), (jD, D) = (
        _pair(a) for a in (xa, dta, Aa, Ba, Ca, Da))
    y, st = ssd_ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    for want_y, want_st in (
            jssd_ops.ssd_scan(jx, jdt, jA, jB, jC, jD, chunk=chunk),
            jm2.ssd_chunked_ref(jx, jdt, jA, jB, jC, jD, chunk)):
        np.testing.assert_allclose(_np(y), _np(want_y), **y_tol)
        np.testing.assert_allclose(_np(st), _np(want_st), **TOL["float32"])


# the Pallas grid's domain: any chunk, head dim, state and B nc (here past
# gridDim.y's 65,535), and block_h dividing H once capped at H
@pytest.mark.parametrize("B,H,nc,L,p,n,block_h", [
    (2, 80, 8, 256, 64, 128, 8), (1, 4, 2, 128, 128, 256, 4),
    (1, 3, 3, 200, 97, 161, 8), (1, 2, 2, 512, 32, 32, 1),
    (4100, 1, 16, 2, 4, 4, 8), (1, 2, 65536, 1, 1, 1, 2)])
def test_ssd_scan_checks_take_the_pallas_domain(B, H, nc, L, p, n, block_h):
    shapes = ((B, H, nc, L, p), (B, H, nc, L), (B, H, nc, L), (B, nc, L, n),
              (B, nc, L, n))
    ssd_kernel.check_args(*shapes, block_h=block_h)
    ssd_kernel.check_args(*shapes, block_h=block_h,
                          dtypes=(torch.float32,) * 5)


@pytest.mark.parametrize("H,block_h,n_c,dtypes,err", [
    (6, 4, 16, None, ValueError),                 # H % block_h
    (4, 8, 8, None, ValueError),                  # C's state width
    (4, 8, 16, (torch.bfloat16,) * 5, TypeError),
    (4, 8, 16, (torch.float32,) * 4 + (torch.float64,), TypeError)])
def test_ssd_scan_checks_refuse_what_the_kernels_refuse(H, block_h, n_c,
                                                        dtypes, err):
    with pytest.raises(err):
        ssd_kernel.check_args((1, H, 2, 32, 8), (1, H, 2, 32), (1, H, 2, 32),
                              (1, 2, 32, 16), (1, 2, 32, n_c),
                              block_h=block_h, dtypes=dtypes)


def _grid_inputs(B, H, nc, L, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, nc, L, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H, nc, L)))).astype(
        np.float32)
    dA = (dt * -np.exp(rng.standard_normal((1, H, 1, 1)) * 0.3)).astype(
        np.float32)
    Bm = (rng.standard_normal((B, nc, L, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, nc, L, n)) * 0.3).astype(np.float32)
    return x, dt, dA, Bm, Cm


@pytest.mark.parametrize("B,H,nc,L,p,n", [(1, 2, 3, 16, 8, 4),
                                          (2, 3, 2, 32, 16, 16)])
def test_ssd_scan_grid_ref_matches_pallas_grid(B, H, nc, L, p, n):
    """The plain version of the kernel's own function, in the chunked
    layout, against the Pallas `ssd_scan_grid` in interpret mode."""
    pairs = [_pair(a) for a in _grid_inputs(B, H, nc, L, p, n,
                                            seed=B + H + nc + L)]
    jy, jst = jssd_scan_grid(*(j for j, _ in pairs), block_h=1,
                             interpret=True)
    y, st = ssd_ref.ssd_scan_grid_ref(*(t for _, t in pairs))
    ky, kst = ssd_kernel.ssd_scan_grid(*(t for _, t in pairs), block_h=H)
    for got_y, got_st in ((y, st), (ky, kst)):
        np.testing.assert_allclose(_np(got_y), _np(jy), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_np(got_st), _np(jst), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("B,H,nc,L,p,n", [
    (1, 4, 4, 32, 32, 16),     # the sweep of test_ssd_scan_sweep_matches_jax
    (2, 8, 4, 64, 64, 32),     # in the chunked layout
    (1, 8, 2, 128, 64, 128),
    (2, 2, 1, 64, 32, 16),     # one chunk
    (1, 2, 3, 16, 8, 4),       # test_ssd_scan_grid_ref_matches_pallas_grid
    (2, 3, 2, 32, 16, 16),
    (1, 2, 3, 96, 32, 128),    # chunks of 96, p = 32 with n = 128
])
def test_ssd_stages_compose_to_the_pallas_grid(B, H, nc, L, p, n):
    """The CUDA kernel's chunk-parallel decomposition, written out as four
    plain stages (C.B^T per chunk; seg and each chunk's own state; the
    carry across chunks; y), composes to the Pallas `ssd_scan_grid` in
    interpret mode: the state-passing algebra, checked on the CPU."""
    pairs = [_pair(a) for a in _grid_inputs(B, H, nc, L, p, n,
                                            seed=B + H + nc + L + n)]
    jy, jst = jssd_scan_grid(*(j for j, _ in pairs), block_h=1,
                             interpret=True)
    x, dt, dA, Bm, Cm = (t for _, t in pairs)
    y, st = ssd_ref.ssd_scan_stages_ref(x, dt, dA, Bm, Cm)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(st), _np(jst), **TOL["float32"])
    # the state entering chunk c is the grid's state after chunk c - 1
    seg, contrib = ssd_ref.ssd_chunk_states(x, dt, dA, Bm)
    s_in, final = ssd_ref.ssd_carry_states(seg, contrib)
    assert torch.equal(s_in[:, :, 0], torch.zeros_like(final))
    if nc > 1:
        _, st_prefix = ssd_ref.ssd_scan_grid_ref(
            x[:, :, :-1], dt[:, :, :-1], dA[:, :, :-1], Bm[:, :-1],
            Cm[:, :-1])
        np.testing.assert_allclose(_np(s_in[:, :, -1]), _np(st_prefix),
                                   **TOL["float32"])


def test_ssd_state_equals_stepwise_decode():
    """Chunked-scan final state (the kernel entry point and the model's
    reference) == the sequential O(1) decode recurrence."""
    xa, dta, Aa, Ba, Ca, _ = _ssd_inputs(1, 64, 2, 16, 8, seed=3)
    x, dt, A, B, C = (torch.from_numpy(a) for a in (xa, dta, Aa, Ba, Ca))
    D = torch.zeros(2)
    _, st_ref = m2.ssd_chunked_ref(x, dt, A, B, C, D, chunk=16)
    _, st_k = ssd_ops.ssd_scan(x, dt, A, B, C, D, chunk=16)
    dtv = torch.nn.functional.softplus(dt)
    st2 = torch.zeros(1, 2, 16, 8)
    for t in range(64):
        dec = torch.exp(dtv[:, t] * A[None])
        st2 = st2 * dec[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtv[:, t], x[:, t], B[:, t])
    for st in (st_ref, st_k):
        np.testing.assert_allclose(st.numpy(), st2.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_ssd_scan_contract():
    xa, dta, Aa, Ba, Ca, Da = _ssd_inputs(1, 64, 4, 8, 4, seed=5)
    t = [torch.from_numpy(a) for a in (xa, dta, Aa, Ba, Ca, Da)]
    with pytest.raises(NotImplementedError):
        ssd_ops.ssd_scan(*t, chunk=16, initial_state=torch.zeros(1, 4, 8, 4))
    with pytest.raises(ValueError):
        ssd_ops.ssd_scan(*t, chunk=30)          # 3 chunks of 22 != 64
    # block_h only groups heads: 4 heads with block_h 8 or 3 give one result
    y8, s8 = ssd_ops.ssd_scan(*t, chunk=16, block_h=8)
    y3, s3 = ssd_ops.ssd_scan(*t, chunk=16, block_h=3)
    assert torch.equal(y8, y3) and torch.equal(s8, s3)
    with pytest.raises(ValueError):
        x = t[0].reshape(1, 4, 16, 4, 8).permute(0, 3, 1, 2, 4).contiguous()
        ssd_kernel.ssd_scan_grid(x, torch.zeros(1, 4, 4, 16),
                                 torch.zeros(1, 4, 4, 16),
                                 torch.zeros(1, 4, 16, 4),
                                 torch.zeros(1, 4, 16, 4), block_h=3)
