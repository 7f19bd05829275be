"""The sLSTM recurrence as one op over the whole sequence (xlstm-125m's
sLSTM layers).

One Hopper source (``csrc/slstm.cu``: ``slstm_fwd``, the scan over time,
and ``slstm_bwd``, its reverse-time transpose) with the plain PyTorch
versions beside it. It replaces no Pallas kernel: the reference's
``repro/models/xlstm.py::slstm_apply`` is a ``lax.scan``, one op whose size
does not depend on S, and its gradient is that scan's transpose. The four
input projections do not depend on the recurrence and are taken outside
(:mod:`..models.xlstm`), so the op takes zx (x's dtype: float32, bfloat16
or float16), the gate pre-activations ip, fp, op (f32), ``r`` (H, hd, hd)
f32 and the initial (c, h) f32.

On the card each (batch row, head) recurrence runs on a thread-block
cluster of C blocks (:func:`plan`): r's column slices in registers as
double, h (or the backward's dzpre) exchanged through distributed shared
memory (stores counted on each block's mbarrier), a helper warp a block
for the inputs, gates and outputs (``csrc/slstm.cu``). The forward past
hd 480 (``kClusterMaxHd``), up to 960 (``kSplitMaxHd``), keeps 32 of a
lane's terms in registers and the rest in the block's shared memory
(:func:`split_shape`). Wider heads (the backward's past 480) launch the
one-block kernels instead (a block per recurrence). The entry points
choose the shape themselves; :func:`plan` asks which. :data:`ROUTES`
counts the launches of each design and dtype.

:func:`slstm_scan` is ``torch.ops.repro_torch.slstm_scan``, a
``torch.library.custom_op`` with three behaviours:

- on CUDA tensors it launches ``slstm_fwd`` and, under autograd,
  ``slstm_bwd`` (``torch.ops.repro_torch.slstm_scan_bwd``), or raises;
- on the CPU it runs the plain versions (:func:`slstm_scan_plain`, the
  loop of the reference's step, and :func:`slstm_scan_bwd_plain`, the
  explicit reverse loop the kernel follows);
- on ``meta`` a fake gives the outputs' shapes, and a FLOP formula counts
  what ``FlopCounterMode`` counts over the plain loop: 2·B·S·d·hd forward
  (the recurrent einsum), the backward's ``r·dzpre`` product (one step
  fewer when h0 takes no gradient), plus the gradient of ``r``, one real
  ``bmm`` that counts itself.

Importing this module registers the ops and their formulas. Under autograd
the forward also returns every step's c, h and z (2·B·S·d f32 and B·S·d
in x's dtype), which the backward reads; without it only the final state.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import flop_registry, register_flop_formula

from ._build import check_launch, library

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # zx, ip, fp, op, r, c0, h0, y, c, h, cs, hs, zs, B, S, H, hd, dtype,
    # save -> cluster, stream
    "slstm_fwd": (_P,) * 13 + (_I,) * 6 + (_IP, _P),
    # gy, gc, gh, ip, fp, op, rT, c0, cs, zs, dzx, dip, dfp, dop, dc0, dh0,
    # B, S, H, hd, dtype, need_dh0 -> cluster, stream
    "slstm_bwd": (_P,) * 16 + (_I,) * 6 + (_IP, _P),
    # chains, hd, dtype, backward -> C, KS, KT, threads, KX
    "slstm_plan": (_I,) * 4 + (_IP,) * 5,
    # C, W, KS, clusters, iters, mode, sink, stream
    "slstm_cluster_probe": (_I,) * 6 + (_P, _P),
}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # the activations'
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the split forward (csrc/slstm.cu): widest head of the cluster kernels
# without it (kClusterMaxHd) and with it (kSplitMaxHd), a lane's terms in
# registers (kSplitKT; the rest in shared memory as float), the most
# threads of a cluster block (kClusterThreads) and of the shared memory a
# block may take with the opt-in (227 KB on the H100)
CLUSTER_MAX_HD, SPLIT_MAX_HD, SPLIT_KT = 480, 960, 32
CLUSTER_THREADS, SMEM_OPTIN = 512, 232448
# steps of prepared inputs and outputs, and of raw words, a block keeps
# (kRing, kRaw); the block's static mbarriers' bytes (Bars)
RING, RAW = 16, 8
BARS_BYTES = 8 * (2 + 2 * RING)
# launches by (kernel, design, activations' dtype), counted where the
# wrappers launch, beside _build.LAUNCHES' one count per kernel: "cluster"
# the cluster kernels, "block" the one-block kernels
ROUTES = {(k, design, str(dt).removeprefix("torch.")): 0
          for k in ("slstm_fwd", "slstm_bwd")
          for design in ("cluster", "block") for dt in DTYPES}


def reset_routes() -> None:
    for key in ROUTES:
        ROUTES[key] = 0


def route_count(kernel: str, design: Optional[str] = None,
                dtype: Optional[str] = None, routes=None) -> int:
    """Launches of ``kernel`` in :data:`ROUTES` (or ``routes``, a copy of
    it), of one design and dtype name where given."""
    routes = ROUTES if routes is None else routes
    return sum(n for (k, g, dt), n in routes.items()
               if k == kernel and design in (None, g)
               and dtype in (None, dt))


def _gates(ip, fp, op):
    return torch.exp(torch.clamp(ip, max=6.0)), torch.sigmoid(fp), \
        torch.sigmoid(op)


def slstm_scan_plain(zx: torch.Tensor, ip: torch.Tensor, fp: torch.Tensor,
                     op: torch.Tensor, r: torch.Tensor, c0: torch.Tensor,
                     h0: torch.Tensor, save: bool = False):
    """The reference's ``_slstm_step`` looped over S, without its input
    projections: returns (y, c, h, cs, hs, zs), y (B, S, d) in zx's dtype,
    (c, h) the final state f32, and with ``save`` every step's c, h (f32)
    and z (zx's dtype) as (B, S, d), else those three as (B, 0, d).
    Differentiable by autograd. The recurrent product h·r is taken in
    float64 and rounded to float32: the correctly rounded f32 product,
    which ``slstm_fwd`` gives bit for bit (a float32 sum's order is the
    library's, and in bf16 a flipped rounding of it is magnified by the
    input gate)."""
    B, S, d = zx.shape
    H, hd = r.shape[0], r.shape[1]
    dt = zx.dtype
    i, f, o = _gates(ip, fp, op)
    r64 = r.double()
    c, h = c0, h0
    ys, cs, hs, zs = [], [], [], []
    for t in range(S):
        rec = torch.einsum("bhx,hxy->bhy", h.reshape(B, H, hd).double(),
                           r64).float().reshape(B, d)
        z = torch.tanh(zx[:, t] + rec.to(dt))
        c = f[:, t] * c + i[:, t] * z.float()
        n = torch.clamp(torch.abs(c), min=1.0)
        h = o[:, t] * (c / n)
        ys.append(h.to(dt))
        if save:
            cs.append(c)
            hs.append(h)
            zs.append(z)

    def stack(xs, dtype):
        return torch.stack(xs, 1) if xs else \
            torch.empty((B, 0, d), dtype=dtype, device=zx.device)
    return (stack(ys, dt), c.clone() if S == 0 else c,
            h.clone() if S == 0 else h, stack(cs, torch.float32),
            stack(hs, torch.float32), stack(zs, dt))


def slstm_scan_bwd_plain(gy, gc, gh, ip, fp, op, r, c0, cs, zs,
                         need_dh0: bool):
    """The reverse loop of :func:`slstm_scan_plain`'s gradient, as
    ``slstm_bwd`` computes it: from the final state's gradients (gc, gh,
    or None) and y's (gy, or None), with the saved c and z, returns the
    gradients (dzx, dip, dfp, dop, dc0, dh0) (dh0 zeros unless
    ``need_dh0``). Rounded in x's dtype where autograd rounds; the gradient
    of r is left to the caller."""
    B, S, d = cs.shape
    H, hd = r.shape[0], r.shape[1]
    dt = zs.dtype
    i, f, o = _gates(ip, fp, op)
    zeros = torch.zeros((B, d), dtype=torch.float32, device=cs.device)
    dc = zeros if gc is None else gc.float()
    dh = zeros if gh is None else gh.float()
    dzx = torch.empty((B, S, d), dtype=dt, device=cs.device)
    dip, dfp, dop = (torch.empty_like(cs) for _ in range(3))
    for t in range(S - 1, -1, -1):
        c = cs[:, t]
        cp = cs[:, t - 1] if t else c0
        z = zs[:, t].float()
        if gy is not None:
            dh = dh + gy[:, t].float()
        n = torch.clamp(torch.abs(c), min=1.0)
        q = c / n
        ot = o[:, t]
        dop[:, t] = dh * q * (1.0 - ot) * ot
        dq = dh * ot
        dn = torch.where(torch.abs(c) >= 1.0, -dq * c / (n * n), 0.0)
        dct = dc + dq / n + dn * torch.sign(c)
        ft, it = f[:, t], i[:, t]
        dfp[:, t] = dct * cp * (1.0 - ft) * ft
        dip[:, t] = torch.where(ip[:, t] <= 6.0, dct * z * it, 0.0)
        dz = (dct * it).to(dt)
        dpre = (dz.float() * (1.0 - z * z)).to(dt)
        dzx[:, t] = dpre
        dc = dct * ft
        if t or need_dh0:
            dh = torch.einsum("bhy,hxy->bhx", dpre.float().reshape(B, H, hd),
                              r).reshape(B, d)
        else:
            dh = zeros
    return dzx, dip, dfp, dop, dc, dh


def _check(name: str, zx, floats) -> str:
    """Check dtypes and devices; returns the one device's type, and raises
    for inputs on more than one device."""
    if zx.dtype not in DTYPES:
        raise TypeError(f"{name}: activations must be one of {DTYPES}, got "
                        f"{zx.dtype}")
    for label, t in floats.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got "
                            f"{t.dtype}")
    devices = {zx.device} | {t.device for t in floats.values()
                             if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs must all lie on one device, got "
                         f"{sorted(map(str, devices))}")
    return zx.device.type


def _kernel_device(name: str, kind: str) -> bool:
    """True for CUDA (launch the kernel), False for the CPU (the plain
    version); any other device raises."""
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs on the CPU or a CUDA device, not "
                         f"{kind}")
    return kind == "cuda"


def _check_shapes(zx, ip, fp, op, r, c0, h0) -> None:
    B, S, d = zx.shape
    if r.dim() != 3 or r.shape[1] != r.shape[2] \
            or r.shape[0] * r.shape[1] != d:
        raise ValueError(f"slstm_scan: r must be (H, hd, hd) with H·hd = "
                         f"{d}, got {tuple(r.shape)}")
    for label, t in (("ip", ip), ("fp", fp), ("op", op)):
        if t.shape != zx.shape:
            raise ValueError(f"slstm_scan: {label} {tuple(t.shape)} != zx "
                             f"{tuple(zx.shape)}")
    for label, t in (("c0", c0), ("h0", h0)):
        if tuple(t.shape) != (B, d):
            raise ValueError(f"slstm_scan: {label} must be ({B}, {d}), got "
                             f"{tuple(t.shape)}")


def split_shape(hd: int, C: int) -> Optional[dict]:
    """The split forward's shape at width hd (CLUSTER_MAX_HD < hd <=
    SPLIT_MAX_HD) on C blocks a chain, as csrc/slstm.cu's ``shape_for``
    chooses it, or None where it does not fit: W = ceil(hd / C) columns a
    block, KS the most lanes a column (a power of two up to 32) whose
    compute threads, rounded to warps, leave room for the helper warp in
    CLUSTER_THREADS; KT = SPLIT_KT terms a lane in registers and KX (the
    rest of ceil(hd / KS), rounded up to a multiple of 4) in shared memory
    as float; ``compute`` and ``threads`` a block and ``smem``
    its dynamic shared bytes, which beside the static barriers must fit
    SMEM_OPTIN. Lane (col, ks) holds the k-pairs ks + i·KS: i < KT / 2 in
    registers, the others at shared term e = 2 (i - KT / 2) + (k % 2),
    word e·compute + col·KS + ks."""
    if not CLUSTER_MAX_HD < hd <= SPLIT_MAX_HD or C < 1 or C & (C - 1):
        return None
    W = -(-hd // C)
    most = CLUSTER_THREADS - 32

    def warps(n):
        return -(-n // 32) * 32
    KS = 32
    while KS > 1 and warps(W * KS) > most:
        KS //= 2
    compute = warps(W * KS)
    KX = -(-(-(-hd // KS)) // 4) * 4 - SPLIT_KT
    HP = (SPLIT_KT + KX) * KS
    smem = (2 * HP * 8 + (RING * W * 7 + RAW * W * 4) * 4
            + KX * compute * 4)
    if compute > most or KX < 4 or smem + BARS_BYTES > SMEM_OPTIN:
        return None
    return dict(C=C, W=W, KS=KS, KT=SPLIT_KT, KX=KX, HP=HP,
                compute=compute, threads=compute + 32, smem=smem)


def plan(chains: int, hd: int, dtype: torch.dtype,
         backward: bool = False) -> dict:
    """The launch shape ``slstm_fwd`` (or ``slstm_bwd``) takes on the
    current card for ``chains`` = B·H recurrences of width hd, as
    ``slstm_plan`` reports it: {"C": blocks a chain (0: the one-block
    kernel, the forward past 960, the backward past 480), "KS": k-slices a
    column, "KT": terms a lane in registers, "threads": a block, "KX":
    float terms a lane in shared memory (the split forward past 480, else
    0)}. The rule (csrc/slstm.cu's header) reads the card's
    SM count and how many clusters it holds at once."""
    out = [ctypes.c_int() for _ in range(5)]
    err = library("slstm", _SIGNATURES).slstm_plan(
        chains, hd, _CODES[dtype], int(backward),
        *(ctypes.byref(o) for o in out))
    if err:
        raise RuntimeError(f"slstm_plan failed with CUDA error {err} for "
                           f"{chains} chains of hd {hd}")
    return dict(zip(("C", "KS", "KT", "threads", "KX"),
                    (o.value for o in out)))


def _count(kernel: str, cluster: ctypes.c_int, dtype: torch.dtype) -> None:
    ROUTES[(kernel, "cluster" if cluster.value else "block",
            str(dtype).removeprefix("torch."))] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _scan_op(zx: torch.Tensor, ip: torch.Tensor, fp: torch.Tensor,
             op: torch.Tensor, r: torch.Tensor, c0: torch.Tensor,
             h0: torch.Tensor, save: bool
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor, torch.Tensor]:
    kind = _check("slstm_scan", zx, dict(ip=ip, fp=fp, op=op, r=r, c0=c0,
                                         h0=h0))
    _check_shapes(zx, ip, fp, op, r, c0, h0)
    if not _kernel_device("slstm_scan", kind):
        return slstm_scan_plain(zx, ip, fp, op, r, c0, h0, save)
    zx, ip, fp, op, r, c0, h0 = (t.contiguous()
                                 for t in (zx, ip, fp, op, r, c0, h0))
    B, S, d = zx.shape
    H, hd = r.shape[0], r.shape[1]
    T = S if save else 0
    y = torch.empty_like(zx)
    c, h = torch.empty_like(c0), torch.empty_like(h0)
    cs = torch.empty((B, T, d), dtype=torch.float32, device=zx.device)
    hs = torch.empty_like(cs)
    zs = torch.empty((B, T, d), dtype=zx.dtype, device=zx.device)
    if B * H == 0:                        # no block to launch
        return y, c, h, cs, hs, zs
    cluster = ctypes.c_int()
    with torch.cuda.device(zx.device):
        err = library("slstm", _SIGNATURES).slstm_fwd(
            *(t.data_ptr() for t in (zx, ip, fp, op, r, c0, h0, y, c, h)),
            _ptr(cs) if save else None, _ptr(hs) if save else None,
            _ptr(zs) if save else None, B, S, H, hd, _CODES[zx.dtype],
            int(save), ctypes.byref(cluster),
            torch.cuda.current_stream().cuda_stream)
    check_launch("slstm_fwd", err)
    _count("slstm_fwd", cluster, zx.dtype)
    return y, c, h, cs, hs, zs


@_scan_op.register_fake
def _scan_fake(zx, ip, fp, op, r, c0, h0, save):
    _check("slstm_scan", zx, dict(ip=ip, fp=fp, op=op, r=r, c0=c0, h0=h0))
    _check_shapes(zx, ip, fp, op, r, c0, h0)
    B, S, d = zx.shape
    T = S if save else 0
    cs = zx.new_empty((B, T, d), dtype=torch.float32)
    return (torch.empty_like(zx), torch.empty_like(c0), torch.empty_like(h0),
            cs, torch.empty_like(cs), zx.new_empty((B, T, d)))


@torch.library.custom_op("repro_torch::slstm_scan_bwd", mutates_args=())
def _bwd_op(gy: Optional[torch.Tensor], gc: Optional[torch.Tensor],
            gh: Optional[torch.Tensor], ip: torch.Tensor, fp: torch.Tensor,
            op: torch.Tensor, r: torch.Tensor, c0: torch.Tensor,
            cs: torch.Tensor, zs: torch.Tensor, need_dh0: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor]:
    floats = dict(gc=gc, gh=gh, ip=ip, fp=fp, op=op, r=r, c0=c0, cs=cs)
    if gy is not None and gy.dtype != zs.dtype:
        raise TypeError(f"slstm_scan_bwd: gy must be {zs.dtype}, got "
                        f"{gy.dtype}")
    if not _kernel_device("slstm_scan_bwd",
                          _check("slstm_scan_bwd", zs, floats)):
        return slstm_scan_bwd_plain(gy, gc, gh, ip, fp, op, r, c0, cs, zs,
                                    need_dh0)
    B, S, d = cs.shape
    H, hd = r.shape[0], r.shape[1]
    rT = r.transpose(1, 2).contiguous()
    gy, gc, gh, ip, fp, op, c0, cs, zs = (
        None if t is None else t.contiguous()
        for t in (gy, gc, gh, ip, fp, op, c0, cs, zs))
    dzx = torch.empty_like(zs)
    dip, dfp, dop = (torch.empty_like(cs) for _ in range(3))
    dc0 = torch.empty_like(c0)
    dh0 = (torch.empty_like(c0) if need_dh0 else torch.zeros_like(c0))
    if B * H == 0:                        # no block to launch
        return dzx, dip, dfp, dop, dc0, dh0
    cluster = ctypes.c_int()
    with torch.cuda.device(zs.device):
        err = library("slstm", _SIGNATURES).slstm_bwd(
            _ptr(gy), _ptr(gc), _ptr(gh),
            *(t.data_ptr() for t in (ip, fp, op, rT, c0, cs, zs, dzx, dip,
                                     dfp, dop, dc0, dh0)),
            B, S, H, hd, _CODES[zs.dtype], int(need_dh0),
            ctypes.byref(cluster), torch.cuda.current_stream().cuda_stream)
    check_launch("slstm_bwd", err)
    _count("slstm_bwd", cluster, zs.dtype)
    return dzx, dip, dfp, dop, dc0, dh0


@_bwd_op.register_fake
def _bwd_fake(gy, gc, gh, ip, fp, op, r, c0, cs, zs, need_dh0):
    return (torch.empty_like(zs), torch.empty_like(cs), torch.empty_like(cs),
            torch.empty_like(cs), torch.empty_like(c0), torch.empty_like(c0))


def _setup_context(ctx, inputs, output):
    zx, ip, fp, op, r, c0, h0, save = inputs
    _, _, _, cs, hs, zs = output
    ctx.mark_non_differentiable(cs, hs, zs)
    ctx.set_materialize_grads(False)
    ctx.save = save
    ctx.save_for_backward(ip, fp, op, r, c0, h0, cs, hs, zs)


def _backward(ctx, gy, gc, gh, _gcs, _ghs, _gzs):
    if not ctx.save:
        raise RuntimeError("slstm_scan: the forward kept no states for the "
                           "backward; call it through slstm_scan()")
    ip, fp, op, r, c0, h0, cs, hs, zs = ctx.saved_tensors
    need = ctx.needs_input_grad
    dzx, dip, dfp, dop, dc0, dh0 = torch.ops.repro_torch.slstm_scan_bwd(
        gy, gc, gh, ip, fp, op, r, c0, cs, zs, need[6])
    dr = None
    if need[4]:
        # dr[head] = sum over (b, t) of h_{t-1}^T dzpre_t: one product
        B, S, d = cs.shape
        H, hd = r.shape[0], r.shape[1]
        h_prev = torch.cat([h0[:, None], hs[:, :-1]], 1)
        dr = torch.bmm(h_prev.reshape(B * S, H, hd).permute(1, 2, 0),
                       dzx.float().reshape(B * S, H, hd).transpose(0, 1))
    return (dzx, dip, dfp, dop, dr, dc0 if need[5] else None,
            dh0 if need[6] else None, None)


_scan_op.register_autograd(_backward, setup_context=_setup_context)


def _fwd_flops(zx, ip, fp, op, r, c0, h0, save, *, out_shape=None,
               **_) -> int:
    """The recurrent einsum's 2·B·d·hd a step, as ``FlopCounterMode``
    counts it over the plain loop."""
    B, S, d = zx
    return 2 * B * S * d * r[1]


def _bwd_flops(gy, gc, gh, ip, fp, op, r, c0, cs, zs, need_dh0, *,
               out_shape=None, **_) -> int:
    """The kernel's r·dzpre product, 2·B·d·hd a step; the plain loop's
    autograd skips it at t = 0 when h0 takes no gradient."""
    B, S, d = cs
    steps = S if need_dh0 else max(S - 1, 0)
    return 2 * B * steps * d * r[1]


for _op, _formula in ((torch.ops.repro_torch.slstm_scan, _fwd_flops),
                      (torch.ops.repro_torch.slstm_scan_bwd, _bwd_flops)):
    if _op not in flop_registry:
        register_flop_formula(_op)(_formula)


def slstm_scan(zx: torch.Tensor, ip: torch.Tensor, fp: torch.Tensor,
               op: torch.Tensor, r: torch.Tensor, c0: torch.Tensor,
               h0: torch.Tensor):
    """The sLSTM scan over S from the state (c0, h0): zx (B, S, d) in the
    activations' dtype (float32, bfloat16 or float16); ip, fp, op (B, S,
    d), r (H, hd, hd), c0 and h0 (B, d), all float32, on one device.
    Returns (y, c, h): y (B, S, d) in zx's dtype and the final state f32.

    One op: on the card ``slstm_fwd`` (and ``slstm_bwd`` under autograd),
    on the CPU the plain versions, on ``meta`` a fake and a FLOP formula.
    The states the backward needs are kept only when autograd records
    (grad mode on and an input that requires grad)."""
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (zx, ip, fp, op, r, c0, h0))
    y, c, h, _, _, _ = torch.ops.repro_torch.slstm_scan(
        zx, ip, fp, op, r, c0, h0, save)
    return y, c, h
