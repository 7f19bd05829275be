"""A numpy emulation of the index logic of flash_attention's bf16 kernel
(``flash_mma_kernel`` in src/repro_torch/kernels/csrc/flash_attention.cu),
held against the kernel's plain version and the Pallas kernel in interpret
mode.

The emulation walks the kernel's tiles as the kernel does: blocks of 64
stacked rows (row rho of a block is query head gr·GB + rho % GB at position
q0 + rho // GB), warps of 16 rows, 64-key stages whose keys past S are
zero-filled, the KV loop stopped at the block's diagonal, masking only in
tiles that reach past a warp's first position, warps skipping tiles wholly
past their last position, the online softmax in exp2 with the scale
hd^-0.5·log2(e), the finite -1e30, masked probabilities set to 0 again, and
(with rounding on) p rounded to bf16 before the PV product. Its products
are numpy's, not the tensor cores': the point is which rows, keys and tiles
meet, not the order of a dot product. Each output must be written exactly
once.

Inputs are standard normal from a numpy seed. With rounding on (q, k, v,
p and o rounded to bf16) the result is held at the reference's bf16
tolerance, 3e-2; with rounding off, at 1e-5 in float32. Causal attention
over the first S positions depends on nothing later, so the Pallas
reference for every S is the prefix of one call at the largest S.
"""
import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention

ROWS, WARP_ROWS, BK = 64, 16, 64         # kRows, 16 rows a warp, kBK
NEG = np.float32(-1e30)
GROUPS = (1, 2, 3, 4, 8)
HEAD_DIMS = (16, 32, 64, 128)
SEQS = (1, 15, 17, 100, 200, 300)
HKV = 2


def round_bf16(x):
    """float32 -> nearest bf16 (ties to even), returned as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def round_f16(x):
    """float32 -> nearest float16 (ties to even), returned as float32."""
    return np.asarray(x, np.float32).astype(np.float16).astype(np.float32)


def emulate(q, k, v, rounding: bool, round_fn=round_bf16, chunk=None):
    """o (B, S, H, hd) as flash_mma_kernel's tile walk computes it, from
    float32 arrays (already rounded to the 16-bit type when ``rounding``;
    ``round_fn`` rounds p and o to it). With ``chunk`` the walk is the wide
    kernels': hd zero-padded to a multiple of ``chunk`` (the scale stays
    the true width's), each block owning one chunk of the output's columns
    and summing the full-width scores over k-chunks of that width."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    GB = min(G, ROWS)
    BQ = ROWS // GB
    n_gr = -(-G // GB)
    n_qt = -(-S // BQ)
    rnd = round_fn if rounding else (lambda x: x)
    scale = np.float32(hd ** -0.5 * np.log2(np.e))
    width = hd if chunk is None else -(-hd // chunk) * chunk
    q, k, v = (np.pad(x, ((0, 0),) * 3 + ((0, width - hd),))
               for x in (q, k, v))
    step = chunk or width
    col_sets = [np.arange(c, c + step) for c in range(0, width, step)]
    o = np.full(q.shape, np.nan, np.float32)
    writes = np.zeros(q.shape[:3] + (len(col_sets),), np.int64)
    rho = np.arange(ROWS)
    warp = rho // WARP_ROWS
    w16 = np.arange(ROWS // WARP_ROWS) * WARP_ROWS
    for b, kvh, gr, qt, ci in itertools.product(
            range(B), range(Hkv), range(n_gr), range(n_qt),
            range(len(col_sets))):
        cols = col_sets[ci]
        q0 = qt * BQ
        qi, g = rho // GB, gr * GB + rho % GB
        pos = q0 + qi
        live = (qi < BQ) & (g < G) & (pos < S)
        h = kvh * G + g
        Q = np.zeros((ROWS, width), np.float32)
        Q[live] = q[b, pos[live], h[live]]
        p_lo = q0 + w16 // GB
        p_hi = q0 + np.minimum(w16 + 15, GB * BQ - 1) // GB
        warp_live = (w16 < GB * BQ) & (p_lo < S)
        m = np.full(ROWS, NEG, np.float32)
        l = np.zeros(ROWS, np.float32)
        acc = np.zeros((ROWS, cols.size), np.float32)
        kv_end = min(S, q0 + BQ)
        # the diagonal stop: no tile starts past the block's last live
        # position
        assert (kv_end - 1) // BK * BK <= pos[live].max()
        for k0 in range(0, kv_end, BK):
            keys = k0 + np.arange(BK)
            inside = keys < S
            Kt = np.zeros((BK, width), np.float32)
            Vt = np.zeros((BK, width), np.float32)
            Kt[inside] = k[b, keys[inside], kvh]
            Vt[inside] = v[b, keys[inside], kvh]
            go = (warp_live & (k0 <= p_hi))[warp]
            masked = (k0 + BK - 1 > p_lo)[warp]
            s = sum(Q[:, c] @ Kt[:, c].T for c in col_sets) * scale
            dead = masked[:, None] & (
                (keys[None] > pos[:, None]) | ~inside[None])
            s = np.where(dead, NEG, s)
            mx = np.maximum(m, s.max(1))
            corr = np.exp2(m - mx)
            p = np.where(dead, 0, np.exp2(s - mx[:, None]))
            l_new = l * corr + p.sum(1, dtype=np.float32)
            acc_new = acc * corr[:, None] + rnd(p) @ Vt[:, cols]
            m = np.where(go, mx, m)
            l = np.where(go, l_new, l)
            acc = np.where(go[:, None], acc_new, acc)
        out = rnd(acc / np.maximum(l, np.float32(1e-30))[:, None])
        o[b, pos[live][:, None], h[live][:, None], cols[None]] = out[live]
        np.add.at(writes, (b, pos[live], h[live], ci), 1)
    assert (writes == 1).all(), "an output not written exactly once"
    return o[..., :hd]


def _qkv(G, hd, S, seed=0):
    rng = np.random.default_rng([seed, G, hd])
    return [rng.standard_normal((1, S, HKV * G if i == 0 else HKV, hd))
            .astype(np.float32) for i in range(3)]


@functools.lru_cache(maxsize=None)
def _pallas(G, hd, rounding):
    """The Pallas kernel in interpret mode at the largest S."""
    q, k, v = _qkv(G, hd, max(SEQS))
    if rounding:
        out = ref_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    else:
        out = ref_flash(q, k, v)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("rounding", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("G", GROUPS)
def test_tile_walk_matches_plain_and_pallas(G, hd, S, rounding):
    q, k, v = (x[:, :S] for x in _qkv(G, hd, max(SEQS)))
    if rounding:
        q, k, v = (round_bf16(x) for x in (q, k, v))
    got = emulate(q, k, v, rounding)
    dtype = torch.bfloat16 if rounding else torch.float32
    before = dict(_build.LAUNCHES)
    plain = flash_attention(*(torch.from_numpy(x).to(dtype)
                              for x in (q, k, v))).float().numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    want = _pallas(G, hd, rounding)[:, :S]
    tol = 3e-2 if rounding else 1e-5
    np.testing.assert_allclose(got, plain, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got[:, 0], np.repeat(v[:, 0], G, axis=1),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("G", GROUPS + (130,))
@pytest.mark.parametrize("S", SEQS)
def test_stacked_rows_cover_every_output_once(G, S):
    """The stacked-row map (including more heads than one block's rows,
    split over groups) writes each (position, head) once; q = k = 0 and
    v = 1, so every output is 1."""
    q = np.zeros((1, S, G, 16), np.float32)
    kv = np.zeros((1, S, 1, 16), np.float32)
    got = emulate(q, kv, kv + 1, rounding=True)
    np.testing.assert_array_equal(got, 1)


ROUNDING = {"bfloat16": (round_bf16, jnp.bfloat16, 3e-2),
            "float16": (round_f16, jnp.float16, 1e-2),
            "float32": (None, jnp.float32, 1e-5)}


def _against_plain_and_pallas(q, k, v, dtype, chunk=None):
    """The emulated walk in ``dtype`` (inputs, p and o rounded to it)
    against the plain version and the Pallas kernel in interpret mode, at
    chip_smoke's tolerance for the dtype (1e-5 in float32)."""
    round_fn, jdt, tol = ROUNDING[dtype]
    if round_fn is not None:
        q, k, v = (round_fn(x) for x in (q, k, v))
        got = emulate(q, k, v, True, round_fn, chunk)
    else:
        got = emulate(q, k, v, False, chunk=chunk)
    before = dict(_build.LAUNCHES)
    plain = flash_attention(*(torch.from_numpy(x).to(getattr(torch, dtype))
                              for x in (q, k, v))).float().numpy()
    assert _build.LAUNCHES == before                  # the CPU launches none
    want = np.asarray(ref_flash(*(jnp.asarray(x, jdt) for x in (q, k, v))),
                      np.float32)
    np.testing.assert_allclose(got, plain, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    G = q.shape[2] // k.shape[2]
    np.testing.assert_allclose(got[:, 0], np.repeat(v[:, 0], G, axis=1),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("S", [17, 100])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_tile_walk_float16(G, hd, S):
    """The f16 instance: the bf16 kernel's walk with p (and o) rounded to
    float16, against the plain version and the Pallas kernel in float16 at
    1e-2."""
    q, k, v = (x[:, :S] for x in _qkv(G, hd, max(SEQS), seed=16))
    _against_plain_and_pallas(q, k, v, "float16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("hd", [300, 320, 512])
def test_column_chunk_walk(hd, dtype):
    """Widths above 256: hd zero-padded to a multiple of 128 (300 -> 384),
    each block owning 128 of the output's columns over the full-width
    scores; every (position, head, chunk) written once, in each dtype."""
    q, k, v = _qkv(2, hd, 70, seed=hd)
    _against_plain_and_pallas(q, k, v, dtype, chunk=128)
