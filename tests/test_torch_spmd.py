"""The port's distributed executor (``repro_torch.distributed``) against the
JAX package's, on the CPU.

The reference side runs once, in a subprocess with 8 forced host devices
(the code string below: this file's top level imports neither JAX nor
``repro``, so the ranks spawned from it start fast). It lowers every cell
from the same numpy arrays, runs its ``to_spmd`` and writes the outputs.
The port side runs each cell in gloo ranks spawned from this file, one
4-rank group (``Machine(("x", 4))`` and ``Machine(("x", 2), ("y", 2))``)
and one 8-rank group (``Machine(("x", 2), ("y", 2), ("z", 2))`` and a
(pod, data) = (2, 4) mesh): every rank lowers the cell itself and calls
``to_spmd(k, mesh)()``. Each cell must match the reference's output at
atol 1e-5 (the reference's own ``to_spmd``-vs-``run()`` tolerance) and be
the port's ``k.run()`` bit for bit on every rank. The rendezvous is a
``FileStore`` under ``tmp_path``; every join has a time limit and a rank
that fails ends its group at once. The single-process invariants follow:
``run_overlapped``, ``profile_pieces`` feeding ``lower(weights=)``, the
run cache on a warm re-lower, and the leaves without a builder.
``serve_rank_main`` is the batched-serving group of
tests/test_torch_serving.py (``lower_batched(..., mesh=...)``), spawned
through ``spawn_ranks`` as well.
"""
import datetime
import inspect
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")
RANK_TIMEOUT_S = 240          # a whole group, from spawn to the last exit


def make_kernel(core, d, cell, **lower_kw):
    """Lower ``cell`` = (name, expr, format, schedule, mesh) from the numpy
    arrays ``d`` with the package ``core`` (``repro.core`` or
    ``repro_torch.core``): the same code builds both sides' kernels."""
    _, expr, fmt, sched, mesh = cell[:5]
    T, L = core.Tensor, core.lower
    fm = {"csr": core.CSR, "csc": core.CSC, "dcsr": core.DCSR,
          "coo": lambda: core.COO(2), "bcsr44": lambda: core.BCSR((4, 4)),
          "bcsr35": lambda: core.BCSR((3, 5)), "coo3": lambda: core.COO(3),
          "csf": core.CSF}[fmt]()
    if expr in ("spmttkrp", "spttv"):
        B = T.from_dense("B", d["B3"], fm)
    else:
        B = T.from_dense("B", d["B"], fm)
    n, m = d["B"].shape
    dense = T.from_dense
    if expr == "spmv":
        stmt = core.parse_tin("a(i) = B(i,j) * c(j)",
                              a=T.zeros_dense("a", (n,)), B=B,
                              c=dense("c", d["c"]))
    elif expr == "spmm":
        stmt = core.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                              A=T.zeros_dense("A", (n, d["C"].shape[1])),
                              B=B, C=dense("C", d["C"]))
    elif expr == "sddmm":
        stmt = core.parse_tin("A(i,j) = B(i,j) * C(i,k) * D(k,j)",
                              A=T("A", B.shape, B.format, B.levels,
                                  np.ones_like(B.vals), B.dtype),
                              B=B, C=dense("C", d["Cs"]),
                              D=dense("D", d["Ds"]))
    elif expr == "spadd3":
        stmt = core.parse_tin(
            "A(i,j) = B(i,j) + C(i,j) + D(i,j)",
            A=T.from_coo("A", (n, m), np.zeros((0, 2)),
                         np.zeros(0, np.float32), core.CSR()),
            B=B, C=T.from_dense("C", d["B2"], fm),
            D=T.from_dense("D", d["B"][::-1].copy(), fm))
    elif expr == "spttv":
        stmt = core.parse_tin(
            "A(i,j) = B(i,j,k) * c(k)",
            A=T.from_coo("A", B.shape[:2], np.zeros((0, 2)),
                         np.zeros(0, np.float32), core.CSR()),
            B=B, c=dense("c", d["c3"]))
    else:
        stmt = core.parse_tin(
            "A(i,l) = B(i,j,k) * C(j,l) * D(k,l)",
            A=T.zeros_dense("A", (B.shape[0], d["C3"].shape[1])), B=B,
            C=dense("C", d["C3"]), D=dense("D", d["D3"]))
    dims = [int(x) for x in mesh.split("x")]
    machine = core.Machine(*zip("xyz", dims))
    schedule = {"rows": L.default_row_schedule,
                "nnz": L.default_nnz_schedule,
                "grid": L.default_grid_schedule,
                "grid_nnz": L.default_grid_nnz_schedule,
                "grid3": L.default_grid3_schedule,
                "rep": L.default_replicated_schedule}[sched](stmt, machine)
    return L.lower(stmt, machine, schedule=schedule, **lower_kw)


# (name, expression, format, schedule, mesh[, overlap chunks])
CELLS4 = [(f"{e}/{f}/{s}/4", e, f, s, "4")
          for e, f, s in [("spmv", "csr", "rows"), ("spmv", "csr", "nnz"),
                          ("spmv", "csc", "nnz"), ("spmm", "csr", "rows"),
                          ("spmm", "csr", "nnz"), ("spmm", "dcsr", "nnz"),
                          ("sddmm", "csr", "rows"), ("sddmm", "coo", "rows"),
                          ("sddmm", "csc", "rows"), ("sddmm", "csr", "nnz")]]
CELLS4 += [(f"{e}/{f}/{s}/4", e, f, s, "4") for f in ("bcsr44", "bcsr35")
           for e in ("spmv", "spmm", "sddmm") for s in ("rows", "nnz")]
CELLS4 += [(f"{e}/{f}/{s}/2x2", e, f, s, "2x2")
           for e, f, s in [("spmv", "csr", "grid"), ("spmm", "csr", "grid"),
                           ("sddmm", "csr", "grid"), ("spmm", "bcsr44", "grid"),
                           ("spmm", "bcsr35", "grid"),
                           ("spmv", "csr", "grid_nnz"),
                           ("spmm", "csr", "grid_nnz")]]
CELLS4 += [(f"spmm/csr/grid/2x2/overlap{c}", "spmm", "csr", "grid", "2x2", c)
           for c in (1, 2, 3)]
CELLS8 = [(f"{e}/{f}/{s}/2x2x2", e, f, s, "2x2x2")
          for e, f, s in [("spmttkrp", "coo3", "grid3"),
                          ("spmttkrp", "csf", "grid3"),
                          ("spmm", "csr", "rep"), ("sddmm", "csr", "rep")]]
# leaves the reference has no builder for
NO_BUILDER = [(f"{e}/{f}/{s}/{m}", e, f, s, m)
              for e, f, s, m in [("spadd3", "csr", "rows", "4"),
                                 ("spadd3", "csr", "nnz", "4"),
                                 ("spttv", "csf", "rows", "4"),
                                 ("spttv", "csf", "nnz", "4"),
                                 ("spmttkrp", "csf", "rows", "4"),
                                 ("spmttkrp", "coo3", "nnz", "4"),
                                 ("spmv", "bcsr44", "grid", "2x2"),
                                 ("sddmm", "bcsr44", "grid", "2x2"),
                                 ("spadd3", "csr", "grid3", "2x2x2")]]
COLLECTIVES = ["hierarchical_grad_reduce", "replicate_all_gather",
               "reduce_rows", "reduce_scatter_rows", "ppermute_ring",
               "mesh_helpers", "nccl_two_ranks_one_device",
               "one_axis_ring_gather_scatter"]


def operands(seed: int = 0):
    rng = np.random.default_rng(seed)
    n, m, J, K = 96, 80, 12, 8

    def sparse(shape, density):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.where(rng.random(shape) < density, x, 0).astype(np.float32)

    B = sparse((n, m), 0.12)
    B[5] = 0                                  # an empty row
    B[17, :60] = rng.standard_normal(60)      # a long one
    return {"B": B, "B2": sparse((n, m), 0.1),
            "c": rng.standard_normal(m).astype(np.float32),
            "C": rng.standard_normal((m, J)).astype(np.float32),
            "Cs": rng.standard_normal((n, K)).astype(np.float32),
            "Ds": rng.standard_normal((K, m)).astype(np.float32),
            "B3": sparse((17, 13, 11), 0.1),
            "c3": rng.standard_normal(11).astype(np.float32),
            "C3": rng.standard_normal((13, 6)).astype(np.float32),
            "D3": rng.standard_normal((11, 6)).astype(np.float32)}


REFERENCE = """
import json, sys
import numpy as np
import repro.core as core
from repro.distributed import mesh as M
from repro.distributed.executor import to_spmd

{make_kernel}

data, cells, no_builder, out = sys.argv[1:5]
d = dict(np.load(data))
res, msgs = {{}}, {{}}
for cell in json.loads(cells):
    k = make_kernel(core, d, cell)
    chunks = cell[5] if len(cell) > 5 else None
    f = (to_spmd(k) if chunks is None
         else to_spmd(k, overlap=True, overlap_chunks=chunks))
    res[cell[0]] = np.asarray(f())
for cell in json.loads(no_builder):
    try:
        to_spmd(make_kernel(core, d, cell))
    except NotImplementedError as e:
        msgs[cell[0]] = str(e)


def err(fn, *a):
    try:
        return repr(fn(*a).dims)
    except ValueError as e:
        return "ValueError: " + str(e)


Mx = core.Machine(("x", 4), ("y", 2))
pod = M.make_mesh((2, 4), ("pod", "data"))
msgs["helpers"] = {{
    "mesh_to_machine": repr(M.mesh_to_machine(pod).dims),
    "data_axes": list(M.data_axes(pod)),
    "axis_size": [M.axis_size(pod, "data"),
                  M.axis_size(pod, "pod", "data", "nope")],
    "resize": err(M.resize_machine, Mx, "y", 3),
    "resize_bad_axis": err(M.resize_machine, Mx, "w", 2),
    "resize_bad_size": err(M.resize_machine, Mx, "x", 0),
    "shrink": err(M.shrink_machine, Mx),
    "shrink_y": err(M.shrink_machine, Mx, "y", 1),
    "shrink_bad_axis": err(M.shrink_machine, Mx, "q"),
    "shrink_empty": err(M.shrink_machine, core.Machine(("x", 1))),
}}
try:
    M.make_mesh((4, 4, 4), ("x", "y", "z"))
except ValueError as e:
    msgs["oversize"] = str(e)
np.savez(out + ".npz", **res)
with open(out + ".json", "w") as fh:
    json.dump(msgs, fh)
"""


def _reference(tmp: Path, data: Path) -> subprocess.Popen:
    prog = ("import os\nos.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            + REFERENCE.format(make_kernel=inspect.getsource(make_kernel)))
    return subprocess.Popen(
        [sys.executable, "-c", prog, str(data),
         json.dumps(CELLS4 + CELLS8), json.dumps(NO_BUILDER),
         str(tmp / "ref")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
                        "HOME": str(tmp),
                        "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS",
                                                        "cpu")})


# ---------------------------------------------------------------------------
# The port's ranks (spawned: everything they need sits at module level)
# ---------------------------------------------------------------------------

def _collective_checks(mesh8, pod, rank):
    """The collectives over the 8-rank meshes; {name: passed}."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import mesh as M
    out = {}
    # identical local gradients: the hierarchical reduce-scatter(data) ->
    # reduce(pod) -> all-gather(data) equals a flat sum over 8 ranks
    g = torch.arange(8.0 * 4).reshape(8, 4)
    got = C.hierarchical_grad_reduce({"g": g}, pod, intra_axis="data",
                                     inter_axis="pod")["g"]
    out["hierarchical_grad_reduce"] = bool(torch.equal(got, g * 8))
    x = torch.full((2, 3), float(rank))
    got = C.replicate_all_gather(x, mesh8, ("y", "z"))
    p = mesh8.coord[0]
    want = torch.cat([torch.full((2, 3), float(p * 4 + i))
                      for i in range(4)])
    out["replicate_all_gather"] = bool(torch.equal(got, want))
    parts = [torch.full((4,), float(r)) / 3 for r in range(8)]
    want = parts[0]
    for t in parts[1:]:
        want = want + t
    out["reduce_rows"] = bool(torch.equal(
        C.reduce_rows(parts[rank], mesh8, ("x", "y", "z")), want))
    y = torch.arange(8.0).repeat(2).reshape(8, 2) + rank
    tot = sum(torch.arange(8.0).repeat(2).reshape(8, 2) + r
              for r in range(4 * (rank // 4), 4 * (rank // 4) + 4))
    i = pod.index("data")
    out["reduce_scatter_rows"] = bool(torch.equal(
        C.reduce_scatter_rows(y, pod, "data"), tot[2 * i:2 * i + 2]))
    got = C.ppermute_ring(torch.tensor([float(rank)]), pod, "data", shift=1)
    base = 4 * (rank // 4)
    out["ppermute_ring"] = float(got) == float(base + (rank - base - 1) % 4)
    if rank == 0:
        out["helpers"] = {
            "mesh_to_machine": repr(M.mesh_to_machine(pod).dims),
            "data_axes": list(M.data_axes(pod)),
            "axis_size": [M.axis_size(pod, "data"),
                          M.axis_size(pod, "pod", "data", "nope")]}
    return out


def _ring_check(world, rank, device):
    """The collectives of one axis on the rank's device: the ring shift
    (staged through the host for gloo on a card, by table), the gather and
    the reduce-scatter."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import mesh as M
    mesh = M.make_mesh((world,), ("x",), backend="gloo", device=device)
    staged = C.TRAFFIC["staged"]
    x = torch.tensor([float(rank)], device=mesh.device)
    ok = float(C.ppermute_ring(x, mesh, "x")) == float((rank - 1) % world)
    ok &= C.TRAFFIC["staged"] - staged == int(mesh.device.type == "cuda")
    ok &= torch.equal(C.replicate_all_gather(x, mesh, "x").cpu(),
                      torch.arange(world, dtype=torch.float32))
    rows = torch.arange(2.0 * world, device=mesh.device) + rank
    want = sum(torch.arange(2.0 * world) + r for r in range(world))
    ok &= torch.equal(C.reduce_scatter_rows(rows, mesh, "x").cpu(),
                      want[2 * rank:2 * rank + 2])
    return bool(ok)


def _nccl_check(rank):
    """NCCL asked for two ranks on one device must raise, naming them."""
    from repro_torch.distributed import mesh as M
    try:
        M.make_mesh((2,), ("x",), backend="nccl", device="cuda:0")
    except ValueError as e:
        return "ranks 0 and 1" in str(e) and "gloo" in str(e)
    return False


def rank_main(rank, world, store, data, cells, out_dir, device="cpu",
              checks=()):
    """One rank: lower every cell on ``device``, run ``to_spmd`` on its
    mesh (gloo), hold it against ``k.run()`` and count its kernel launches
    (on a card the cell's kernel, ``call.launches`` times a call, and no
    other; none on the CPU); rank 0 writes the outputs. ``checks`` adds
    the collective checks of the 8-rank group ("collectives") or the NCCL
    guard ("nccl")."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    status = {"rank": rank, "ok": False}
    try:
        import repro_torch.core as core
        from repro_torch.distributed import mesh as M
        from repro_torch.distributed.executor import to_spmd
        from repro_torch.kernels import _build
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        d = dict(np.load(data))
        meshes = {}
        for label in sorted({c[4] for c in cells}, key=len):
            dims = [int(x) for x in label.split("x")]
            meshes[label] = M.make_mesh(dims, "xyz"[:len(dims)],
                                        backend="gloo", device=device)
        outs, bits, launches = {}, {}, {}
        for cell in cells:
            k = make_kernel(core, d, cell, device=device)
            chunks = cell[5] if len(cell) > 5 else None
            f = (to_spmd(k, meshes[cell[4]]) if chunks is None else
                 to_spmd(k, meshes[cell[4]], overlap=True,
                         overlap_chunks=chunks))
            before = dict(_build.LAUNCHES)
            y = f()
            got = {n: c - before[n] for n, c in _build.LAUNCHES.items()
                   if c != before[n]}
            want_launches = ({f.kernel: f.launches}
                             if torch.device(device).type == "cuda" else {})
            launches[cell[0]] = got == want_launches
            want = k.run()
            if not torch.is_tensor(want):
                want = torch.from_numpy(np.asarray(want.vals)).to(y.device)
            bits[cell[0]] = bool(torch.equal(y, want))
            outs[cell[0]] = y.cpu().numpy()
        status["collectives"] = {}
        if "collectives" in checks:
            pod = M.make_mesh((2, 4), ("pod", "data"), backend="gloo",
                              device=device)
            status["collectives"] = _collective_checks(meshes["2x2x2"], pod,
                                                       rank)
        if "ring" in checks:
            status["collectives"]["one_axis_ring_gather_scatter"] = \
                _ring_check(world, rank, device)
        if "nccl" in checks:
            status["collectives"]["nccl_two_ranks_one_device"] = \
                _nccl_check(rank)
        status.update(ok=True, bits=bits, launches=launches)
        if rank == 0:
            np.savez(os.path.join(out_dir, "port.npz"), **outs)
    except Exception:
        status["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(status, fh)
    if dist.is_initialized():
        dist.destroy_process_group()
    if not status["ok"]:
        sys.exit(1)


def serve_rank_main(rank, world, store, data, cells, out_dir,
                    device="cpu", checks=()):
    """One rank of the batched-serving group: ``lower_batched(...,
    mesh=...)`` over the integer SpMV of ``data`` for each schedule in
    ``cells`` ("rows", "nnz" on 4 pieces, "grid" on 2x2), a batch of 8 and
    one of 3 requests; each output must be the single-process
    ``run_many``'s bit for bit and the exact product on every rank."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    status = {"rank": rank, "ok": False}
    try:
        import repro_torch.core as core
        from repro_torch.core import lower as L
        from repro_torch.distributed import mesh as M
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        d = dict(np.load(data))
        n, m = d["B"].shape
        stmt = core.parse_tin(
            "a(i) = B(i,j) * c(j)", a=core.Tensor.zeros_dense("a", (n,)),
            B=core.Tensor.from_dense("B", d["B"], core.CSR()),
            c=core.Tensor.zeros_dense("c", (m,)))
        bits, exact, leaves = {}, {}, {}
        for sched in cells:
            dims = (2, 2) if sched == "grid" else (world,)
            machine = core.Machine(*zip("xy", dims))
            mesh = M.make_mesh(dims, "xy"[:len(dims)], backend="gloo",
                               device=device)
            fn = {"rows": None, "nnz": L.default_nnz_schedule,
                  "grid": L.default_grid_schedule}[sched]
            bk = L.lower_batched(stmt, machine, batch=8, schedule=fn,
                                 mesh=mesh, device=device)
            plain = L.lower_batched(stmt, machine, batch=8, schedule=fn,
                                    device=device)
            ok_bits = ok_exact = True
            for reqs in (list(d["R"]), list(d["R"][:3])):
                got, want = bk.run_many(reqs), plain.run_many(reqs)
                for g, w, r in zip(got, want, reqs):
                    ok_bits &= bool(torch.equal(g, w))
                    ok_exact &= bool(np.array_equal(g.cpu().numpy(),
                                                    d["B"] @ r))
            bits[sched], exact[sched] = ok_bits, ok_exact
            leaves[sched] = bk._entries[8].kernel.leaf_name
        status.update(ok=True, bits=bits, exact=exact, leaves=leaves)
    except Exception:
        status["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(status, fh)
    if dist.is_initialized():
        dist.destroy_process_group()
    if not status["ok"]:
        sys.exit(1)


def spawn_ranks(world, cells, data, out_dir, device="cpu", checks=(),
                timeout=RANK_TIMEOUT_S, target=None):
    """Run ``target`` (by default ``rank_main``) in ``world`` spawned
    processes; returns the rank statuses. A rank that fails ends the group
    at once; a group past ``timeout`` is killed and fails, naming the ranks
    still running."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=target or rank_main,
                         args=(r, world, store, str(data), cells, out_dir,
                               device, tuple(checks)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    statuses = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.json")
        statuses.append(json.load(open(path)) if os.path.exists(path)
                        else {"rank": r, "ok": False,
                              "error": f"exit code {procs[r].exitcode}"})
    bad = [s for s in statuses if not s["ok"]]
    if bad or hung:
        raise AssertionError(
            f"{world}-rank group failed (still running: {hung}): "
            + "; ".join(f"rank {s['rank']}: {s.get('error', '')[-1500:]}"
                        for s in bad))
    return statuses


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both sides of every cell: the reference subprocess runs while the
    port's 4-rank and then 8-rank groups do."""
    tmp = tmp_path_factory.mktemp("spmd")
    data = tmp / "data.npz"
    np.savez(data, **operands())
    ref = _reference(tmp, data)
    try:
        port = {}
        for world, cells, checks in ((4, CELLS4, ("nccl", "ring")),
                                     (8, CELLS8, ("collectives",))):
            out = tmp / f"w{world}"
            out.mkdir()
            statuses = spawn_ranks(world, cells, data, str(out),
                                   checks=checks)
            port[world] = (statuses, dict(np.load(out / "port.npz")))
        _, err = ref.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return {"ref": dict(np.load(tmp / "ref.npz")),
            "ref_msgs": json.load(open(tmp / "ref.json")), "port": port}


@pytest.mark.parametrize("cell", CELLS4 + CELLS8, ids=lambda c: c[0])
def test_spmd_cell_against_reference(results, cell):
    statuses, outs = results["port"][4 if cell in CELLS4 else 8]
    for s in statuses:
        assert s["bits"][cell[0]], (cell[0], s["rank"], "differs from run()")
        assert s["launches"][cell[0]], (cell[0], s["rank"], "launches")
    np.testing.assert_allclose(outs[cell[0]], results["ref"][cell[0]],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_on_ranks(results, name):
    if name == "mesh_helpers":
        got = results["port"][8][0][0]["collectives"]["helpers"]
        ref = results["ref_msgs"]["helpers"]
        for key in got:
            assert got[key] == ref[key], key
        return
    world = 8 if name in COLLECTIVES[:5] else 4
    for s in results["port"][world][0]:
        assert s["collectives"][name], (name, s["rank"])


@pytest.mark.parametrize("cell", NO_BUILDER, ids=lambda c: c[0])
def test_no_builder_raises_as_reference(results, cell):
    import repro_torch.core as core
    from repro_torch.distributed.executor import to_spmd
    k = make_kernel(core, operands(), cell, device="cpu")
    with pytest.raises(NotImplementedError) as e:
        to_spmd(k)
    assert str(e.value) == results["ref_msgs"][cell[0]]


def test_machine_helpers_and_guards_as_reference(results):
    import repro_torch.core as core
    from repro_torch.distributed import mesh as M
    ref = results["ref_msgs"]

    def err(fn, *a):
        try:
            return repr(fn(*a).dims)
        except ValueError as e:
            return "ValueError: " + str(e)

    Mx = core.Machine(("x", 4), ("y", 2))
    got = {"resize": err(M.resize_machine, Mx, "y", 3),
           "resize_bad_axis": err(M.resize_machine, Mx, "w", 2),
           "resize_bad_size": err(M.resize_machine, Mx, "x", 0),
           "shrink": err(M.shrink_machine, Mx),
           "shrink_y": err(M.shrink_machine, Mx, "y", 1),
           "shrink_bad_axis": err(M.shrink_machine, Mx, "q"),
           "shrink_empty": err(M.shrink_machine, core.Machine(("x", 1)))}
    for key, v in got.items():
        assert v == ref["helpers"][key], key
    # the oversized grid fails fast, naming its pieces and the ranks seen
    with pytest.raises(ValueError) as e:
        M.make_mesh((4, 4, 4), ("x", "y", "z"), backend="gloo", device="cpu")
    assert "64 pieces" in str(e.value) and "1 visible" in str(e.value)
    assert ref["oversize"].split(" exceeds")[0] == \
        str(e.value).split(" exceeds")[0]


# ---------------------------------------------------------------------------
# Single-process invariants (tests/test_serving.py, tests/test_telemetry.py
# and tests/test_replan_cache.py, held inside the port)
# ---------------------------------------------------------------------------

def _int_spmm(seed, n=96, m=80, j=24, fmt="csr"):
    import repro_torch.core as core
    rng = np.random.default_rng(seed)
    dB = np.where(rng.random((n, m)) < 0.15,
                  rng.integers(-3, 4, (n, m)), 0).astype(np.float32)
    dB[7] = 0
    dC = rng.integers(-3, 4, (m, j)).astype(np.float32)
    fm = core.BCSR((4, 4)) if fmt == "bcsr" else core.CSR()
    return core.parse_tin("A(i,j) = B(i,k) * C(k,j)",
                          A=core.Tensor.zeros_dense("A", (n, j)),
                          B=core.Tensor.from_dense("B", dB, fm),
                          C=core.Tensor.from_dense("C", dC))


def _lower(stmt, sched, **kw):
    import repro_torch.core as core
    L = core.lower
    if sched == "grid":
        machine = core.Machine(("x", 2), ("y", 2))
        s = L.default_grid_schedule(stmt, machine)
    else:
        machine = core.Machine(("x", 4))
        s = (L.default_nnz_schedule(stmt, machine) if sched == "nnz"
             else L.default_row_schedule(stmt, machine))
    return L.lower(stmt, machine, schedule=s, device="cpu", **kw)


@pytest.mark.parametrize("sched", ["rows", "nnz", "grid"])
def test_run_overlapped_bit_for_bit(sched):
    from repro_torch.distributed.executor import run_overlapped
    k = _lower(_int_spmm(7), sched)
    ref = k.run()
    for chunks in (1, 2, 3, 5):
        assert torch.equal(ref, run_overlapped(k, chunks=chunks))
        assert torch.equal(ref, run_overlapped(k, chunks=chunks,
                                               overlap=False))


def test_overlap_telemetry_and_attribution():
    from repro_torch.distributed.executor import run_overlapped
    from repro_torch.runtime import telemetry
    k = _lower(_int_spmm(8), "rows")
    tr = telemetry.TRACER
    was = tr.enabled
    tr.clear()
    tr.enable()
    telemetry.METRICS.clear()
    try:
        run_overlapped(k, chunks=3)
        rep = telemetry.overlap_report()
    finally:
        tr.enabled = was
    assert rep["chunks"] == 3
    assert rep["comm_s"] > 0 and rep["bytes"] > 0
    assert 0 < rep["efficiency"] <= 1.0
    snap = telemetry.METRICS.snapshot()
    for name in ("comm_seconds", "hidden_seconds", "bytes", "hidden_bytes"):
        assert f"executor.overlap.{name}" in snap["counters"]
    assert snap["gauges"]["executor.overlap.efficiency"] == \
        pytest.approx(rep["efficiency"])
    # attribution only: overlap bytes never inflate the comm model
    d = k.comm.as_dict()
    assert d["overlap_total_bytes"] == k.comm.overlap_total_bytes > 0
    assert k.comm.overlap_hidden_bytes <= k.comm.overlap_total_bytes
    assert d["total_network_bytes"] == k.comm.total_network_bytes()
    assert "overlap_total_bytes" not in _lower(_int_spmm(8),
                                               "nnz").comm.as_dict()


def test_run_overlapped_rejects_bcsr():
    from repro_torch.distributed.executor import run_overlapped
    k = _lower(_int_spmm(9, 64, 48, 8, fmt="bcsr"), "rows")
    with pytest.raises(NotImplementedError):
        run_overlapped(k)


def test_profile_pieces_feeds_weighted_lower():
    import repro_torch.core as core
    from repro_torch.distributed.executor import profile_pieces
    from repro_torch.runtime import telemetry
    stmt = _int_spmm(2, 48, 40, 8)
    core.clear_lowering_caches()
    telemetry.METRICS.clear()
    k = _lower(stmt, "nnz")
    ref = k.run()
    prof = profile_pieces(k, iters=2, warmup=1)
    assert prof.leaf_name == k.leaf_name
    assert prof.seconds.shape == (k.strategy.pieces,)
    assert np.all(prof.seconds > 0) and prof.skew() >= 1.0
    w = prof.replan_weights()
    assert w.shape == prof.seconds.shape
    assert abs(w.mean() - 1.0) < 1e-6        # StragglerMitigator convention
    # slower piece -> smaller weight (fewer non-zeros next plan)
    assert np.argmin(w) == np.argmax(prof.seconds)
    k2 = _lower(stmt, "nnz", weights=w)
    torch.testing.assert_close(k2.run(), ref, atol=1e-4, rtol=0)
    snap = telemetry.METRICS.snapshot()
    h = snap["histograms"]["executor.piece_seconds"]
    assert h["count"] == k.strategy.pieces       # one best-of obs per piece
    assert snap["gauges"]["executor.piece_skew"] == pytest.approx(
        prof.skew())
    assert prof.as_dict()["skew"] == prof.skew()


@pytest.mark.parametrize("sched", ["rows", "grid"])
def test_profile_pieces_other_leaves(sched):
    from repro_torch.distributed.executor import profile_pieces
    k = _lower(_int_spmm(3, 48, 40, 8), sched)
    prof = profile_pieces(k, iters=1, warmup=1)
    assert prof.seconds.shape == (k.strategy.pieces,)
    assert not prof.stragglers(threshold=1e9)
    kb = _lower(_int_spmm(3, 48, 40, 8, fmt="bcsr"), sched)
    with pytest.raises(NotImplementedError):
        profile_pieces(kb)


def test_spmd_runner_cache_reuse():
    import repro_torch.core as core
    from repro_torch.distributed import executor
    from repro_torch.runtime import telemetry
    stmt = _int_spmm(43)
    machine = core.Machine(("x", 1))      # one piece: no process group
    executor.clear_spmd_cache()
    k1 = core.lower.lower(stmt, machine, device="cpu")
    y1 = executor.to_spmd(k1)()
    misses1 = executor.SPMD_RUN_STATS["misses"]
    k2 = core.lower.lower(stmt, machine, device="cpu")   # warm re-lower ...
    y2 = executor.to_spmd(k2)()           # ... reuses the rank callable
    assert k2.cache.warm
    assert executor.SPMD_RUN_STATS["misses"] == misses1
    assert executor.SPMD_RUN_STATS["hits"] >= 1
    assert torch.equal(y1, y2) and torch.equal(y1, k1.run())
    assert "spmd_run" in telemetry.METRICS.cache_stats()


def test_chip_smoke_executor_path_on_cpu(tmp_path, capfd):
    """The chip script's path 4g at a tiny size, on the CPU: the operands
    written once and memory-mapped by the ranks, the 4-rank and 8-rank
    groups (every cell the rank's k.run() bit for bit and within the host
    product's tolerance on rank 0, one [spmd] line each), then
    profile_pieces and run_overlapped in the parent; no kernel
    launches."""
    import argparse
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    data = chip_smoke.make_inputs(256, 4, 8, seed=0, dims3=(64, 16, 16),
                                  rank=4)
    data["add"] = chip_smoke.add_operands(256, 0, data["B"])
    chip_smoke.save_spmd_operands(data, tmp_path)
    launches = chip_smoke.executor_path(argparse.Namespace(reps=4),
                                        torch.device("cpu"), tmp_path)
    assert set(launches.values()) == {0}
    out = capfd.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("[spmd] ")]
    assert len(lines) == sum(map(len, chip_smoke.SPMD_CELLS.values()))
    assert all("bits_equal_run=True" in l and "backend=gloo" in l
               for l in lines)
    assert out.count("[spmd-profile] ") == len(chip_smoke.SPMD_PROFILED)
    assert out.count("[spmd-overlap] ") == 4 * len(chip_smoke.SPMD_OVERLAPPED)
