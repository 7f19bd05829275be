"""A numpy emulation of the sLSTM cluster kernels' index logic
(``csrc/slstm.cu``: ``slstm_fwd_cluster``, ``slstm_bwd_cluster``), held
against the plain loops of ``repro_torch.kernels.slstm`` on the CPU.

The emulation follows the kernels block by block and step by step: block
``rank`` of a chain's cluster owns columns [rank W, rank W + W); thread
(col, ks) holds the k-pairs ks + i KS (i < KT / 2) of its column of r,
widened to double; the products go to four chains, then an xor shuffle
tree over the column's KS lanes. Each live block keeps the whole exchanged
vector double-buffered: the vector of iteration u goes into buffer
(u + 1) & 1 of every live block (ranks past the head's width receive
nothing), iteration u reads buffer u & 1, and the last vector is sent only
where it is read (the backward's dh0). A block's helper warp copies the
4-byte word holding each input element of an iteration (16-bit streams
also from a base 2 bytes off a word) into a raw ring of ``RAW`` iterations,
``RAW - 1`` ahead, prepares the inputs into a ring of ``RING`` iterations
that it shares with the compute warps, and stores the outputs they leave
there; the backward walks t down and takes c_{t-1} from the raw words of
the next iteration. Every slot and buffer entry carries the
iteration it holds, and each read checks it, so a wrong slot, parity,
column or rank would fail here before the kernel's first card call (the
emulation does not check addresses on the card).

The split forward (past hd 480, up to 960) keeps a lane's k-pairs i <
KT / 2 in registers and the others in the block's shared memory, modelled
as a flat NaN-filled array of words at the kernel's addresses (term e of
compute thread tid at e·compute + tid) whose every word carries the (column,
k) it holds: each product reads each term of its column exactly once from
the slot ``slstm.split_shape`` gives it, and the chains take the shared
pairs on in turn after the registers'.

The forward's pointwise math runs on the whole (B, d) of a step, as the
plain loop runs it, on the products and inputs the blocks assembled: y and
the final state must be the plain loop's bits (both sum h·r in double).
The backward's gradients lie within 1e-5 relative of the plain reverse
loop's in f32 (which sums r·dzpre in float32), 2e-2 in bf16 and f16."""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, slstm as K


def _constant(name: str) -> int:
    """A ``constexpr int`` of ``csrc/slstm.cu``, read from the source."""
    text = (_build.CSRC / _build.SOURCES["slstm"]).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


RING = _constant("kRing")
RAW = _constant("kRaw")


def _inputs(B, S, H, hd, dt, seed):
    g = torch.Generator().manual_seed(seed)
    d = H * hd
    zx = (torch.randn(B, S, d, generator=g) * 2).to(dt)
    ip = torch.randn(B, S, d, generator=g) * 4 + 1
    fp = torch.randn(B, S, d, generator=g) * 2
    op = torch.randn(B, S, d, generator=g)
    r = torch.randn(H, hd, hd, generator=g) * hd ** -0.5
    c0 = torch.randn(B, d, generator=g) * 2
    h0 = torch.randn(B, d, generator=g)
    return zx, ip, fp, op, r, c0, h0


class _Memory:
    """A stream as device memory: its bytes at ``base`` (an address, maybe
    2 bytes off a word) inside a buffer padded to whole words around it."""

    def __init__(self, t: torch.Tensor, base_off: int):
        raw = t.contiguous().view(-1).view(torch.uint8).numpy()
        self.dtype = t.dtype
        self.size = t.element_size()
        self.base = 64 + base_off
        self.buf = np.zeros(self.base + raw.size + 8, np.uint8)
        self.buf[self.base:self.base + raw.size] = raw

    def word(self, elem: int) -> np.ndarray:
        """fetch_column's copy: the aligned word holding ``elem``."""
        addr = (self.base + elem * self.size) & ~3
        return self.buf[addr:addr + 4].copy()

    def value(self, word: np.ndarray, elem: int) -> torch.Tensor:
        """Word<T>::get: the element's bytes within its word."""
        lo = (self.base + elem * self.size) & 3
        return torch.from_numpy(word[lo:lo + self.size].copy()).view(
            self.dtype)[0]


def _column_dot(v, rr, KS, KT, split=None):
    """column_dot for every thread of a block: v (HP,) float64, rr
    (ncol, KS, KT) float64, ``split`` the block's shared terms (a _Split)
    or None; returns (ncol,), after checking that every lane of a column
    holds the same bits."""
    ks = np.arange(KS)
    a = np.zeros((4,) + rr.shape[:2])
    for i in range(0, KT // 2, 2):
        p = 2 * (ks + i * KS)
        a[0] = a[0] + v[p] * rr[:, :, 2 * i]
        a[1] = a[1] + v[p + 1] * rr[:, :, 2 * i + 1]
        if i + 1 < KT // 2:
            q = 2 * (ks + (i + 1) * KS)
            a[2] = a[2] + v[q] * rr[:, :, 2 * i + 2]
            a[3] = a[3] + v[q + 1] * rr[:, :, 2 * i + 3]
    if split is not None:
        for e in range(0, split.KX, 4):
            p = 2 * (ks + (KT // 2 + e // 2) * KS)
            q = p + 2 * KS
            a[0] = a[0] + v[p] * split.read(e, p)
            a[1] = a[1] + v[p + 1] * split.read(e + 1, p + 1)
            a[2] = a[2] + v[q] * split.read(e + 2, q)
            a[3] = a[3] + v[q + 1] * split.read(e + 3, q + 1)
    acc = (a[0] + a[1]) + (a[2] + a[3])
    o = KS >> 1
    while o:
        acc = acc + acc[:, ks ^ o]
        o >>= 1
    assert (acc == acc[:, :1]).all()
    return acc[:, 0]


def _slice(m, hd, W, KS, KT, rank, KX=0):
    """load_slice for every thread of block ``rank``: (W, KS, KT) float64
    (and, with KX, load_split's KX terms a lane past them); each k < hd of
    a live column held exactly once over both."""
    col, ks, i, e = np.meshgrid(np.arange(W), np.arange(KS),
                                np.arange((KT + KX) // 2), np.arange(2),
                                indexing="ij")
    k = 2 * (ks + i * KS) + e
    j = rank * W + col
    live = (j < hd) & (k < hd)
    vals = np.zeros(k.shape)
    vals[live] = m[k[live], j[live]]
    seen = np.zeros((W, hd), int)
    np.add.at(seen, (col[live], k[live]), 1)
    alive = (rank * W + np.arange(W)) < hd
    assert (seen[alive] == 1).all() and (seen[~alive] == 0).all()
    return vals.reshape(W, KS, KT + KX)[:, :, :KT]


class _Split:
    """A block's shared terms of the split forward: words e·compute + tid
    (tid = col·KS + ks), NaN-filled, each holding r's term (k, column) as
    float32 (widened at the read), tagged with the k it holds; ``read``
    checks the k and counts the reads."""

    def __init__(self, m, hd, W, KS, KT, KX, compute, rank):
        self.KX, self.compute, self.KS, self.W = KX, compute, KS, W
        self.words = np.full(KX * compute, np.nan, np.float32)
        self.k = np.full(KX * compute, -1)
        self.reads = np.zeros(KX * compute, int)
        col, ks, e = np.meshgrid(np.arange(W), np.arange(KS), np.arange(KX),
                                 indexing="ij")
        k = 2 * (ks + (KT // 2 + e // 2) * KS) + e % 2
        j = rank * W + col
        live = (j < hd) & (k < hd)
        at = e * compute + col * KS + ks
        self.at = at
        self.words[at] = 0.0
        self.words[at[live]] = m[k[live], j[live]]
        self.k[at] = k
        self.tid = (np.arange(W)[:, None] * KS + np.arange(KS)).reshape(
            W, KS)

    def read(self, e, k):
        """term e of every lane (ncol, KS), whose k-pair value is ``k``
        (KS,), widened to double"""
        at = e * self.compute + self.tid
        assert (self.k[at] == k[None, :]).all()
        self.reads[at] += 1
        got = self.words[at].astype(np.float64)
        assert not np.isnan(got).any()
        return got


class _Chain:
    """One cluster: its blocks' r slices and vector buffers (with the
    iteration each entry holds), and each live block's helper: its raw
    ring of RAW iterations, and the ring of RING iterations of prepared
    inputs and of outputs it shares with the compute warps. The helper
    runs as far ahead as the kernel lets it: iterations 0 .. RING - 1
    prepared before the first step, then, once the compute warps left
    iteration u's outputs, it stores them and prepares u + RING."""

    def __init__(self, m, hd, C, KS, KT, streams, rowj0, S, d, step_of,
                 prep, store, split=None):
        self.hd, self.C, self.KS, self.KT = hd, C, KS, KT
        self.W = -(-hd // C)
        KX = split["KX"] if split else 0
        self.HP = (KT + KX) * KS
        assert self.HP >= hd and KT % 2 == 0 and KX % 4 == 0
        self.live_ranks = min(C, -(-hd // self.W))
        self.streams, self.rowj0, self.S, self.d = streams, rowj0, S, d
        self.step_of = step_of                 # iteration -> step
        self.prep, self.store = prep, store
        self.buf = np.zeros((C, 2, self.HP))
        self.tag = np.full((C, 2, self.HP), -9)
        self.blocks = []
        for rank in range(C):
            col0 = rank * self.W
            ncols = max(0, min(self.W, hd - col0))
            self.blocks.append(dict(
                rank=rank, col0=col0, ncols=ncols,
                rr=_slice(m, hd, self.W, KS, KT, rank, KX),
                split=None if split is None else _Split(
                    m, hd, self.W, KS, KT, KX, split["compute"], rank),
                raw=np.zeros((RAW, self.W, len(streams), 4), np.uint8),
                raw_tag=np.full(RAW, -1), fetched=0,
                ring_in=[None] * RING, in_tag=np.full(RING, -1),
                ring_out=[None] * RING, out_tag=np.full(RING, -1)))
        for blk in self.blocks[:self.live_ranks]:
            for p in range(RAW - 1):
                self.fetch(blk, p)
            for p in range(min(S, RING)):
                self.prepare(blk, p)

    def elem(self, blk, col, p):
        return self.rowj0 + blk["col0"] + col + self.step_of(p) * self.d

    def fetch(self, blk, p):
        """The helper's copy of iteration p's raw words (an empty group
        past S)."""
        assert p == blk["fetched"]
        blk["fetched"] += 1
        if p >= self.S:
            return
        # the slot held p - RAW, which prepare(p - RAW + 1) read last
        assert blk["raw_tag"][p % RAW] in (p - RAW, -1)
        for col in range(blk["ncols"]):
            for a, m in enumerate(self.streams):
                if m is not None:
                    blk["raw"][p % RAW, col, a] = m.word(
                        self.elem(blk, col, p))
        blk["raw_tag"][p % RAW] = p

    def raw_value(self, blk, col, p, a):
        assert blk["raw_tag"][p % RAW] == p
        return self.streams[a].value(blk["raw"][p % RAW, col, a],
                                     self.elem(blk, col, p))

    def prepare(self, blk, p):
        """Iteration p's inputs into ring slot p % RING, after the copy of
        p + RAW - 1, from the raw words of p (and p + 1)."""
        self.fetch(blk, p + RAW - 1)
        assert blk["in_tag"][p % RING] in (p - RING, -1)
        blk["ring_in"][p % RING] = [
            self.prep(lambda a, v=p, c=col: self.raw_value(blk, c, v, a),
                      blk["col0"] + col, p)
            for col in range(blk["ncols"])]
        blk["in_tag"][p % RING] = p

    def inputs(self, blk, u):
        """The compute warps' read of iteration u's prepared inputs."""
        assert blk["in_tag"][u % RING] == u
        return blk["ring_in"][u % RING]

    def outputs(self, blk, u, vals):
        """The compute warps' outputs of iteration u into its slot, then
        the helper's store of them and its preparation of u + RING."""
        assert blk["out_tag"][u % RING] in (u - RING, -1)
        blk["ring_out"][u % RING] = vals
        blk["out_tag"][u % RING] = u
        self.drain(blk, u)
        if u + RING < self.S:
            self.prepare(blk, u + RING)

    def drain(self, blk, u):
        assert blk["out_tag"][u % RING] == u
        for col, v in enumerate(blk["ring_out"][u % RING]):
            self.store(v, blk["col0"] + col, self.step_of(u))

    def product(self, blk, u):
        """The products of iteration u, from buffer u & 1 holding the
        vector of iteration u - 1 in every live unit."""
        own = self.tag[blk["rank"], u & 1]
        assert (own[:self.hd] == u - 1).all() and (own[self.hd:] == -9).all()
        return _column_dot(self.buf[blk["rank"], u & 1], blk["rr"], self.KS,
                           self.KT, blk["split"])

    def send(self, u, values):
        """Every live block's columns of iteration u's vector (``values``
        by unit) into buffer (u + 1) & 1 of every live block, whose last
        entry there is of iteration u - 2 (read at u - 1)."""
        # every live block's live columns cover the units 0 .. hd - 1 once
        units = np.concatenate([blk["col0"] + np.arange(blk["ncols"])
                                for blk in self.blocks])
        assert np.array_equal(np.sort(units), np.arange(self.hd))
        to = slice(0, self.live_ranks)
        nb = (u + 1) & 1
        assert np.isin(self.tag[to, nb][:, units], (u - 2, -9)).all()
        self.buf[to, nb, units] = values[units]
        self.tag[to, nb, units] = u
        for q in range(self.live_ranks, self.C):
            assert (self.tag[q] == -9).all()


def _emulate_fwd(ins, C, KS, KT, base_off, split=None):
    zx, ip, fp, op, r, c0, h0 = ins
    B, S, d = zx.shape
    H, hd = r.shape[0], r.shape[1]
    dt = zx.dtype
    streams = [_Memory(zx, base_off), _Memory(ip, 0), _Memory(fp, 0),
               _Memory(op, 0)]
    i_all, f_all, o_all = K._gates(ip, fp, op)
    r64 = r.double().numpy()
    y, zs = torch.zeros_like(zx), torch.zeros_like(zx)
    cs, hs = torch.zeros(B, S, d), torch.zeros(B, S, d)
    chains = []
    for b in range(B):
        for head in range(H):
            state = head * hd

            def prep(get, j, p):
                # zx and the gates' pre-activations (the emulation checks
                # them; the gates are the plain loop's below)
                return [get(a) for a in range(4)]

            def store(v, j, t, b=b, state=state):
                y[b, t, state + j] = v[0].to(dt)
                hs[b, t, state + j] = v[0]
                cs[b, t, state + j] = v[1]
                zs[b, t, state + j] = v[2].to(dt)
            ch = _Chain(r64[head], hd, C, KS, KT, streams,
                        b * S * d + state, S, d, lambda u: u, prep, store,
                        split)
            # h0 in buffer 0 of every live block, as iteration -1's vector
            ch.buf[:ch.live_ranks, 0, :hd] = h0[
                b, state:state + hd].double().numpy()
            ch.tag[:ch.live_ranks, 0, :hd] = -1
            chains.append((b, state, ch))
    c, h = c0.clone(), h0.clone()
    for t in range(S):
        rec = torch.full((B, d), float("nan"))
        got = [torch.zeros((B, d), dtype=dt)] + [torch.zeros((B, d))
                                                 for _ in range(3)]
        for b, state, ch in chains:
            for blk in ch.blocks[:ch.live_ranks]:
                cur = ch.inputs(blk, t)
                acc = ch.product(blk, t)
                for col in range(blk["ncols"]):
                    unit = state + blk["col0"] + col
                    assert torch.isnan(rec[b, unit])
                    rec[b, unit] = torch.tensor(acc[col]).float()
                    for a in range(4):
                        got[a][b, unit] = cur[col][a]
        assert not torch.isnan(rec).any()
        for a, want in enumerate((zx, ip, fp, op)):
            assert torch.equal(got[a], want[:, t])
        z = torch.tanh(got[0] + rec.to(dt))
        c = f_all[:, t] * c + i_all[:, t] * z.float()
        n = torch.clamp(torch.abs(c), min=1.0)
        h = o_all[:, t] * (c / n)
        for b, state, ch in chains:
            if t <= S - 2:
                ch.send(t, h[b, state:state + hd].double().numpy())
            for blk in ch.blocks[:ch.live_ranks]:
                units = range(state + blk["col0"],
                              state + blk["col0"] + blk["ncols"])
                ch.outputs(blk, t, [(h[b, u], c[b, u], z[b, u].float())
                                    for u in units])
    for _, _, ch in chains:             # every shared term read once a step
        for blk in ch.blocks[:ch.live_ranks]:
            if blk["split"] is not None:
                sp = blk["split"]
                assert (sp.reads[sp.at] == S).all()
                assert sp.reads.sum() == sp.at.size * S
    return y, c, h, cs, zs


def _emulate_bwd(gy, gc, gh, ip, fp, op, r, c0, cs, zs, need_dh0, C, KS, KT,
                 base_off):
    B, S, d = cs.shape
    H, hd = r.shape[0], r.shape[1]
    dt = zs.dtype
    streams = [_Memory(cs, 0), _Memory(zs, base_off), _Memory(ip, 0),
               _Memory(fp, 0), _Memory(op, 0),
               None if gy is None else _Memory(gy, base_off)]
    last = S - 1 if need_dh0 else S - 2
    dzx = torch.zeros_like(zs)
    dip, dfp, dop = (torch.zeros_like(cs) for _ in range(3))
    dc0, dh0 = torch.empty(B, d), torch.zeros(B, d)
    rT64 = r.transpose(1, 2).double().numpy()
    for b in range(B):
        for head in range(H):
            state = head * hd

            def prep(get, j, p, b=b, state=state):
                # c_t, c_{t-1} (the next iteration's cs; c0 at t = 0), z,
                # ip, the gates, gy
                t = S - 1 - p
                vi = get(2)
                return [get(0), get(0, p + 1) if t > 0 else c0[b, state + j],
                        get(1).float(), vi, *K._gates(vi, get(3), get(4)),
                        0.0 if gy is None else get(5).float()]

            def store(v, j, t, b=b, state=state):
                dzx[b, t, state + j] = v[0]
                dip[b, t, state + j] = v[1]
                dfp[b, t, state + j] = v[2]
                dop[b, t, state + j] = v[3]
            ch = _Chain(rT64[head], hd, C, KS, KT, streams,
                        b * S * d + state, S, d, lambda u: S - 1 - u, prep,
                        store)
            zero = torch.zeros(hd)
            dc = (zero if gc is None else gc[b, state:state + hd]).clone()
            dhc = (zero if gh is None else gh[b, state:state + hd]).clone()
            for u in range(S):
                dpre_all = np.zeros(hd)
                outs = {}
                for blk in ch.blocks[:ch.live_ranks]:
                    cur = ch.inputs(blk, u)
                    if u > 0:
                        acc = ch.product(blk, u)
                        cols = slice(blk["col0"], blk["col0"] + blk["ncols"])
                        dhc[cols] = torch.from_numpy(
                            acc[:blk["ncols"]]).float()
                    outs[blk["rank"]] = []
                    for col in range(blk["ncols"]):
                        j = blk["col0"] + col
                        c, cp, z, vi, i_, f_, o_, gyv = cur[col]
                        dh = dhc[j] + gyv
                        n = torch.clamp(torch.abs(c), min=1.0)
                        q = c / n
                        dopv = dh * q * (1.0 - o_) * o_
                        dq = dh * o_
                        dct = dc[j] + dq / n
                        if abs(float(c)) >= 1.0 and float(c) != 0.0:
                            dn = -dq * c / (n * n)
                            dct = dct + (dn if float(c) > 0 else -dn)
                        dfpv = dct * cp * (1.0 - f_) * f_
                        dipv = dct * z * i_ if float(vi) <= 6.0 else 0.0
                        dz = (dct * i_).to(dt).float()
                        dpre = (dz * (1.0 - z * z)).to(dt)
                        dc[j] = dct * f_
                        dpre_all[j] = float(dpre)
                        outs[blk["rank"]].append((dpre, dipv, dfpv, dopv))
                if u <= last:
                    ch.send(u, dpre_all)
                for blk in ch.blocks[:ch.live_ranks]:
                    ch.outputs(blk, u, outs[blk["rank"]])
            dc0[b, state:state + hd] = dc
            if need_dh0 and S:
                for blk in ch.blocks[:ch.live_ranks]:
                    acc = ch.product(blk, S)
                    cols = slice(state + blk["col0"],
                                 state + blk["col0"] + blk["ncols"])
                    dh0[b, cols] = torch.from_numpy(
                        acc[:blk["ncols"]]).float()
            elif need_dh0:
                dh0[b, state:state + hd] = dhc
    return dzx, dip, dfp, dop, dc0, dh0


# (hd, C, KS, KT): the reduced width on one block; a ragged split (20
# columns over 16 blocks of 2: ranks 10-15 own none and receive nothing);
# KS = 8 lanes with KT 8 (pairs interleaved past hd); the hd 192 shape's KT
# at a narrow width; KT 16 over 10 terms a lane; a stream longer than RING
# steps is in every case. Each shape runs once, in one layout of the
# forward's inputs and one dtype and state of the backward's.
SHAPES = [(16, 1, 1, 16), (20, 16, 2, 16), (40, 4, 8, 8), (48, 2, 2, 24),
          (24, 8, 1, 24)]
# (dtype, the byte offset of the 16-bit streams' base from a word): a
# float32 stream starts on a word; a 16-bit one may start 2 bytes into one
LAYOUTS = [("float32", 0), ("bfloat16", 0), ("bfloat16", 2),
           ("float16", 0), ("float16", 2)]
FWD_CASES = [(shape, *layout) for shape, layout in zip(SHAPES, LAYOUTS)]
BWD_CASES = [(shape, dtype, need) for shape, dtype, need in zip(
    SHAPES, ["float32", "bfloat16", "float16", "bfloat16", "float16"],
    [True, False, True, True, False])]


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize(
    "shape,dtype,base_off", FWD_CASES,
    ids=["hd{}-C{}-KS{}-KT{}-{}-{}".format(*s, d, o)
         for s, d, o in FWD_CASES])
def test_cluster_forward_emulation_gives_the_plain_loops_bits(shape, dtype,
                                                              base_off):
    hd, C, KS, KT = shape
    dt = getattr(torch, dtype)
    ins = _inputs(2, RING + 3, 2, hd, dt, seed=hd + C)
    got = _emulate_fwd(ins, C, KS, KT, base_off)
    y, c, h, cs, _, zs = K.slstm_scan_plain(*ins, save=True)
    for a, b in zip(got, (y, c, h, cs, zs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "shape,dtype,need_dh0", BWD_CASES,
    ids=["hd{}-C{}-KS{}-KT{}-{}-{}".format(
        *s, d, "state-grad" if n else "zero-state")
        for s, d, n in BWD_CASES])
def test_cluster_backward_emulation_matches_the_plain_reverse_loop(
        shape, dtype, need_dh0):
    hd, C, KS, KT = shape
    dt = getattr(torch, dtype)
    zx, ip, fp, op, r, c0, h0 = _inputs(2, RING + 3, 2, hd, dt,
                                        seed=hd + 7 * C)
    _, _, _, cs, _, zs = K.slstm_scan_plain(zx, ip, fp, op, r, c0, h0,
                                            save=True)
    g = torch.Generator().manual_seed(3)
    gy = torch.randn(zx.shape, generator=g).to(dt)
    gc = torch.randn(c0.shape, generator=g)
    gh = torch.randn(c0.shape, generator=g) if need_dh0 else None
    want = K.slstm_scan_bwd_plain(gy, gc, gh, ip, fp, op, r, c0, cs, zs,
                                  need_dh0)
    got = _emulate_bwd(gy, gc, gh, ip, fp, op, r, c0, cs, zs, need_dh0, C,
                       KS, KT, 2 if dtype != "float32" else 0)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, a, b in zip(("dzx", "dip", "dfp", "dop", "dc0", "dh0"), got,
                          want):
        assert a.dtype == b.dtype, name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("S", [0, 1, 2])
def test_cluster_backward_emulation_without_gy_at_short_lengths(S):
    """gy absent (its stream null) and S in {0, 1, 2}: no product inside
    the loop at S = 1, dh0 from the last exchange (or gh at S = 0)."""
    zx, ip, fp, op, r, c0, h0 = _inputs(1, S, 2, 16, torch.float32, seed=5)
    _, _, _, cs, _, zs = K.slstm_scan_plain(zx, ip, fp, op, r, c0, h0,
                                            save=True)
    gc, gh = torch.ones_like(c0), torch.full_like(c0, 0.5)
    want = K.slstm_scan_bwd_plain(None, gc, gh, ip, fp, op, r, c0, cs, zs,
                                  True)
    got = _emulate_bwd(None, gc, gh, ip, fp, op, r, c0, cs, zs, True, 2, 2,
                       8, 0)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-6


def test_split_constants_match_the_source():
    """slstm.py's mirror of the split forward (its widths, register terms,
    threads, rings and shared terms as float) is the source's;
    ``split_shape``'s widest width at 16 blocks is kSplitMaxHd, with no
    shape past it, and at 8 blocks (the rule's C for more chains than
    clusters of 16 the card holds) 640."""
    for name, value in (("kClusterMaxHd", K.CLUSTER_MAX_HD),
                        ("kSplitMaxHd", K.SPLIT_MAX_HD),
                        ("kSplitKT", K.SPLIT_KT),
                        ("kClusterThreads", K.CLUSTER_THREADS),
                        ("kRing", K.RING), ("kRaw", K.RAW)):
        assert _constant(name) == value, name
    text = (_build.CSRC / _build.SOURCES["slstm"]).read_text()
    assert "(size_t)KX * compute * sizeof(float)" in text
    assert "slstm_fwd_cluster<T, kSplitKT, true>" in text
    fits = [hd for hd in range(K.CLUSTER_MAX_HD + 1, 2 * K.SPLIT_MAX_HD)
            if K.split_shape(hd, 16) is not None]
    assert fits == list(range(K.CLUSTER_MAX_HD + 1, K.SPLIT_MAX_HD + 1))
    assert K.split_shape(K.CLUSTER_MAX_HD, 16) is None
    assert [hd for hd in range(K.CLUSTER_MAX_HD + 1, K.SPLIT_MAX_HD + 1)
            if K.split_shape(hd, 8) is not None] == list(
        range(K.CLUSTER_MAX_HD + 1, 641))


# (hd, C, heads, dtype, the 16-bit streams' offset): phase 3's hd 640 in
# bf16 on 16 blocks (2 heads) and on 8 (the rule's C at 10 chains; 1
# head), and the split forward's widest width in f32 (1 head)
SPLIT_CASES = [(640, 16, 2, "bfloat16", 2), (640, 8, 1, "bfloat16", 2),
               (K.SPLIT_MAX_HD, 16, 1, "float32", 0)]


@pytest.mark.parametrize(
    "hd,C,H,dtype,base_off", SPLIT_CASES,
    ids=[f"hd{h}-{d}-{o}" + ("" if C == 16 else f"-C{C}")
         for h, C, _, d, o in SPLIT_CASES])
def test_split_forward_emulation_gives_the_plain_loops_bits(hd, C, H, dtype,
                                                            base_off):
    """The split forward on C blocks, as ``split_shape`` gives it (hd 640
    at C 16: W 40, KS 8, KT 32 + KX 48; at C 8: W 80, KS 4, KX 128; hd 960
    at C 16: W 60, KX 88), over RING + 3 steps of one batch row and H
    heads: every shared term read once a step from its slot, y and the
    final state the plain loop's bits."""
    sh = K.split_shape(hd, C)
    dt = getattr(torch, dtype)
    ins = _inputs(1, RING + 3, H, hd, dt, seed=hd)
    got = _emulate_fwd(ins, C, sh["KS"], sh["KT"], base_off, split=sh)
    y, c, h, cs, _, zs = K.slstm_scan_plain(*ins, save=True)
    for a, b in zip(got, (y, c, h, cs, zs)):
        assert torch.equal(a, b)
