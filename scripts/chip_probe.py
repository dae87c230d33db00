"""Short calls on the GPU ahead of the full ``chip_smoke.py``.

    python3 scripts/chip_probe.py                 # bf16 kernels, bucket phase
    python3 scripts/chip_probe.py --first-calls   # first calls on HEALPix
    python3 scripts/chip_probe.py --compare       # parent against this tree
    python3 scripts/chip_probe.py --compare synth # the synthesis kernels

Every mode builds the kernels (their ``-Xptxas -v`` logs go to
``chiprun_out/``).  With no option it holds the bfloat16 branch of kernels
10 and 12 against its bf16 plain version at l_max 256 (K 1, 2, 3, 8; fold
on and off; spin 0 and 2; random tables and none) and prints each gap
beside the bf16-vs-float32 gap; runs HEALPix nside 64 plans on every
layout on the card against the same plans on the CPU, twice for identical
bits; and times the bucket phase stage and the fused directions at nside
1024/K8 and 2048/K1.  With ``--first-calls`` it times only the first
calls on a new HEALPix grid (plan, bucket index, first bucket FFTs) at
nside 1024 and 2048.

``--compare [vpu|mxu|synth]`` measures a kernel change against the parent
commit in one call, on one card: unpack the parent first (``git archive
<parent> | tar -x -C checkouts/parent``; ``/checkouts/`` is git-ignored).
It imports the parent's kernel wrappers from there beside this tree's, so
each tree is called through its own wrappers and builds its own sources
into its own ``_build`` directory (four ``nvcc`` together; run it before
anything else builds this tree, or this tree's ``-Xptxas -v`` log is not
written).  It writes both trees' ``-Xptxas -v`` logs and the SASS of the
vpu kernels (9, 11 and 7 of ``fused``, 1 and 3 of ``legendre``) and of
the mxu kernels (12 and 10 with their bf16 instantiations, 4 and 2) to
``chiprun_out/``, names every kernel whose SASS differs from the parent's,
and counts the inner loops of the main paths' instantiations by opcode
(for the mxu kernels also the SASS instructions a triple at 16 channels:
the panel build's steady path over the steps it stores, plus the
contraction loop's instructions over its FFMA; for the vpu synthesis at K
1 the unguarded steady loop's path over its 2 steps of 4 rings).  Then,
in turns (parent, this tree, this tree, parent;
``chip_smoke.cuda_time_ms``, mean of 5 each), each on
``chip_smoke.py``'s own main-path inputs, printing both trees' digests
(those its log prints) and the gap between the analyses:

* ``vpu``: ``anal_reduce`` on both routes (the plain grid's rows
  with their m, the slot layouts' streams as each tree's analyses reduce
  them) beside ``part.sum(dim=1)`` at every shape of the main paths, with
  each call's host time when calls run back to back, holding this tree's
  output equal to the parent's bit for bit; kernels 9
  (``synth_fused_vpu``), 11 (``anal_fused_vpu``) and 7
  (``anal_packed_vpu``) at GL 4096/K1 spin 0 and 2 and HEALPix 2048/K1
  spin 0, kernel 5 (``synth_packed_vpu``) on the packed GL 4096/K1 path
  and kernel 3 (``anal_vpu``) on the plain one, spin 0 and 2 (kernel 7's
  digests also on its packed paths at GL 1024/K1, kernel 3's also on its
  phase-2 operands and the plain reduce of its partials), whether the
  synthesis outputs are equal bit for bit; kernel 9 also at GL 4096 with K
  4 and 7; then ``chip_smoke.py``'s packed main path at GL 4096/K1 for its
  direction times;
* ``mxu``: the registers and stack, spill store and spill load
  bytes of every mxu analysis instantiation of both trees; every output
  of ``chip_smoke.py``'s phase 2 (the kernels against their plain
  versions at l_max 256) through both trees, those that moved with both
  digests and their gap; kernel 12
  (``anal_fused_mxu``) on the fused paths at GL 2048/K8 and HEALPix
  1024/K8, spin 0 and 2, with its bf16 instantiation on
  ``chip_smoke.py``'s BF16_PATHS; kernel 8 (``anal_packed_mxu``) on the
  packed GL 2048/K8 paths at full width (the smoke runs them at l_max
  1024); kernel 4 (``anal_mxu``) on the plain paths of both grids; then
  kernel 11 at GL 4096 with K 4 and 7 (its map chunk of 2: each tree's,
  timed, bits compared);
* ``synth``: the registers and stack, spill store and spill load bytes of
  every synthesis instantiation of both trees; every output of
  ``chip_smoke.py``'s phase 2 through both trees, as ``mxu`` does; then,
  each with whether its outputs are equal to the parent's bit for bit and
  its share of the issue rate (the SASS counts above x the path's
  triples / (132 SMs x 128 lanes x the SM clock) over the time): kernel 2
  (``synth_mxu``) on the plain paths at GL 2048/K8 and HEALPix 1024/K8,
  spin 0 and 2; as the controls kernel 1 (``synth_vpu``) on the plain GL
  4096/K1 path, spin 0 and 2, and at K 4 and 7, kernel 10
  (``synth_fused_mxu``) on the fused paths at GL 2048/K8 and HEALPix
  1024/K8, spin 0 and 2, with its bf16 instantiation on
  ``chip_smoke.py``'s BF16_PATHS, kernel 6 (``synth_packed_mxu``) on the
  packed GL 2048/K8 paths at full width, and kernels 9 and 5 on the fused
  and packed GL 4096/K1 paths, spin 0 and 2; last, the plan-level outputs
  the other parts do not reach, both directions through both trees on
  ``chip_smoke.py``'s own inputs: its packed paths (l_max 1024) and its
  ragged-grid paths (HEALPix bucket, ring-uniform HEALPix, ECP), each
  ``alm2map`` and ``map2alm`` with both digests, bit equality and the gap.

With no part named all three run.  Prints numbers only; the checks that
pass or fail are ``chip_smoke.py``'s.
"""
import collections
import contextlib
import functools
import inspect
import os
import re
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
os.makedirs("chiprun_out", exist_ok=True)

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import build, fused, fused_cuda, ops  # noqa: E402
from repro_torch.kernels import legendre_cuda as lc  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
PARENT = os.path.join(ROOT, "checkouts", "parent")


def import_parent():
    """The parent checkout's ``build``, ``legendre_cuda`` and ``fused_cuda``
    modules, imported beside this tree's: each keeps its own sources,
    ``_build`` directory, library and launch counters."""
    def ours():
        return [k for k in sys.modules
                if k == "repro_torch" or k.startswith("repro_torch.")]

    mine = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, os.path.join(PARENT, "src"))
    try:
        from repro_torch.kernels import build as pb
        from repro_torch.kernels import fused_cuda as pfc
        from repro_torch.kernels import legendre_cuda as plc
    finally:
        sys.path.pop(0)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)
    return types.SimpleNamespace(build=pb, lc=plc, fc=pfc)


t0 = time.time()
trees = {"this tree": types.SimpleNamespace(build=build, lc=lc, fc=fused_cuda)}
if "--compare" in sys.argv:
    trees = {"parent": import_parent(), **trees}
libs = {}                       # tree -> {source: library path}


def _build(tag, tree):
    """Build ``tree``'s sources; its ``-Xptxas -v`` logs to chiprun_out/."""
    for name, (path, log) in tree.build.build().items():
        libs.setdefault(tag, {})[name] = path
        if log:                 # empty for a library built earlier
            pre = "parent_" if tag == "parent" else ""
            with open(f"chiprun_out/ptxas_{pre}{name}.log", "w") as fh:
                fh.write(log)


jobs = [threading.Thread(target=_build, args=kv) for kv in trees.items()]
for j in jobs:
    j.start()
for j in jobs:
    j.join()
if any(len(libs.get(t, {})) != len(build.SOURCES) for t in trees):
    sys.exit("a kernel build failed (its error is above)")
print("build s", time.time() - t0, flush=True)
dev = torch.device("cuda")


def first_calls(nside, K):
    """Seconds of the first calls on a new HEALPix grid: the plan, its
    bucket index, the first and second bucket synthesis (K and 2K
    channels), and single first FFTs of a few of its bucket lengths."""
    t = time.time()
    p = repro_torch.make_plan("healpix", nside=nside, K=K, dtype="float32")
    t_plan = time.time() - t
    t = time.time()
    ph = p.phase
    t_index = time.time() - t
    out = [f"nside {nside} K {K}: make_plan {t_plan:.2f} s, bucket index "
           f"{t_index:.2f} s"]
    for C in (K, 2 * K):
        d = torch.zeros(p.m_max + 1, p.grid.n_rings, C, dtype=torch.complex64,
                        device=dev)
        maps = torch.zeros(p.grid.n_rings, p.grid.max_n_phi, C, device=dev)
        for what in ("first", "second"):
            for direction, fn, arg in (("synthesis", ph.synth, d),
                                       ("analysis", ph.anal, maps)):
                torch.cuda.synchronize()
                t = time.time()
                fn(arg)
                torch.cuda.synchronize()
                out.append(f"{what} bucket {direction}, {C} channels: "
                           f"{time.time() - t:.3f} s")
    for n in (4 * nside, 4 * nside - 4, 4 * nside - 12, 3 * 4 * 7 * 11):
        x = torch.zeros(3, n, 5, dtype=torch.complex64, device=dev)
        torch.cuda.synchronize()
        t = time.time()
        torch.fft.ifft(x, dim=1)
        torch.cuda.synchronize()
        out.append(f"first ifft of length {n}: {time.time() - t:.4f} s")
    print("\n  ".join(out), flush=True)


# ---------------------------------------------------------------------------
# --compare: the parent's kernels against this tree's, in one call, each
# tree through its own wrappers
# ---------------------------------------------------------------------------


def _slot_reduce(tree):
    """``tree``'s slot-route reduce as its own analyses call it (a tree
    whose ``_reduce`` takes the partials alone passes every slot as m =
    0)."""
    if len(inspect.signature(tree.fc._reduce).parameters) == 1:
        return lambda part, maps, l_max, spin: tree.fc._reduce(part)
    return tree.fc._reduce


def _turns(name, old, new, labels=("parent", "this tree")):
    """Time ``old`` and ``new`` in turns (old, new, new, old) and print."""
    t = [cs.cuda_time_ms(fn) for fn in (old, new, new, old)]
    po, pn = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"  {name}: {labels[0]} {t[0]:.4f} {t[3]:.4f} ms, {labels[1]} "
          f"{t[1]:.4f} {t[2]:.4f} ms; means {po:.4f} -> {pn:.4f} "
          f"({pn / po:.3f}x)", flush=True)
    return po, pn


def host_us(fn, n: int = 200) -> float:
    """Microseconds a call of ``fn`` when ``n`` calls are queued back to
    back: its host time wherever that outlasts its kernel."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def _sass(path):
    """{kernel name without its file's namespace: [SASS instructions]} of a
    built library (``cuobjdump -sass``)."""
    sass = subprocess.run([os.path.join(os.path.dirname(build._nvcc()),
                                        "cuobjdump"), "-sass", path],
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                         line.split("Function :")[1].strip())
            funcs[cur] = []
        elif cur:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                funcs[cur].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


#: per library: (name pattern, main-path instantiation) of the kernels
#: whose SASS goes to ``chiprun_out/`` and whose loops are counted, spin 0
#: and 2 (fused: kernels 9 and 11 at KM 1 and kernels 12 and 10, float32
#: and bf16, at KM 8, fold off; legendre: kernels 1 and 3 at KC 2 and
#: kernels 4 and 2 at CC 16, fold off)
SASS_KERNELS = {
    "fused": ((r"(anal|synth)_fused_vpu_kernelI\w+?EE", "ILi1ELb0ELb1E"),
              (r"(anal|synth)_fused_mxu_kernelI\w+?EE", "ILi8ELb0ELb1E")),
    "legendre": ((r"(anal|synth)_vpu_kernelI\w+?EE", "ILi2ELb0E"),
                 (r"(anal|synth)_mxu_kernelI\w+?EE", "ILi16ELb0E"))}

#: SASS instructions a triple of the main-path instantiations, filled by
#: ``_sass_report``: {(tree, kernel name): count}
PER_TRIPLE = {}

#: channels a block contracts in the mxu main-path instantiations above
MXU_CC = 16


def _loops(ins):
    """Each loop (a backward branch) of a kernel's SASS holding no barrier:
    (instructions, steady path, opcode counts)."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    for i, (a, txt) in enumerate(ins):
        m = re.search(r"BRA\s.*0x([0-9a-f]+)", txt)
        if not (m and int(m.group(1), 16) <= a
                and int(m.group(1), 16) in at):
            continue
        loop = ins[at[int(m.group(1), 16)]:i + 1]
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
            for _, t in loop)
        if "BAR" not in ops:           # the loops inside a tile or panel
            yield loop, _steady_path(loop), ops


def _mxu_per_triple(loops):
    """SASS instructions a (row, l, ring) triple of an mxu instantiation at
    MXU_CC channels, from its loops: the panel build (the loop with FMUL
    and shared stores: its steady path over the recurrence steps it
    stores, STS 1, STS.64 2, STS.128 4) plus the contraction (the loop with
    the most FFMA: its instructions times MXU_CC over its FFMA; none on the
    tensor-core branch, whose contraction is unrolled; the float32 mxu
    synthesis has no build loop: its one loop of steps and FFMA counts as
    the contraction)."""
    build = contract = None
    for loop, steady, ops in loops:
        sts = sum({"": 1, "64": 2, "128": 4}.get(
            (re.search(r"STS(?:\.(\d+))?", t).group(1) or ""), 1)
            for _, t in loop if re.search(r"\bSTS\b", t))
        if ops.get("FMUL") and sts and not (ops.get("FFMA")
                                            or ops.get("LDG")):
            build = steady / sts
        if ops.get("FFMA", 0) >= 8 and (
                contract is None or ops["FFMA"] > contract[1]):
            contract = (len(loop) * MXU_CC / ops["FFMA"], ops["FFMA"])
    return build, contract and contract[0]


def _sass_report(old_path, new_path, lib):
    """Which kernels of a library compiled to other SASS than the parent's;
    for the main paths' instantiations of :data:`SASS_KERNELS`, each loop
    holding no barrier, by opcode, and for the mxu analyses the
    instructions a triple.  Their SASS goes to
    ``chiprun_out/sass_<tree>_<library>.txt``."""
    old, new = _sass(old_path), _sass(new_path)
    changed = sorted(n for n in new if old.get(n) != new[n])
    short = [re.search(r"([a-z_]+_kernel)I", n) for n in changed]
    print(f"  {lib}: {len(changed)} of {len(new)} kernels compile to other "
          f"SASS than the parent's: "
          f"{sorted(set(m.group(1) for m in short if m))}", flush=True)
    for tag, funcs in (("parent", old), ("tree", new)):
        with open(f"chiprun_out/sass_{tag}_{lib}.txt", "w") as fh:
            for pattern, main in SASS_KERNELS[lib]:
                for n, ins in funcs.items():
                    hit = re.search(pattern, n)
                    if not hit:
                        continue
                    fh.write(f"Function : {n}\n" + "\n".join(
                        f"/*{a:04x}*/ {t};" for a, t in ins) + "\n")
                    name = hit.group(0)
                    if main not in name:
                        continue
                    print(f"  {tag} SASS {name}: {len(ins)} instructions",
                          flush=True)
                    loops = list(_loops(ins))
                    for loop, steady, ops in loops:
                        print(f"    loop of {len(loop)}, steady path "
                              f"{steady}: {dict(ops.most_common())}",
                              flush=True)
                    if "mxu" in name:
                        b, c = _mxu_per_triple(loops)
                        print(f"    a triple at {MXU_CC} channels: build "
                              f"{b}, contraction {c}", flush=True)
                        # the float32 mxu synthesis steps and contracts in
                        # one loop (counted as the contraction)
                        PER_TRIPLE[(tag, name)] = (b or 0) + (c or 0)
                    elif name.startswith("synth") and loops:
                        # the steady steps of a full ring block: of the
                        # loops with the most FFMA the unguarded (shortest)
                        # one, two steps of 4 rings a pass at K 1
                        steady = min(loops, key=lambda x: (
                            -x[2].get("FFMA", 0), x[1]))[1]
                        PER_TRIPLE[(tag, name)] = steady / 8
                        print(f"    a triple at K 1: {steady / 8}",
                              flush=True)


def _steady_path(loop):
    """Instructions issued in one pass through a loop body when every
    predicated branch falls through and every unconditional one is taken
    (the path of a step past the seed: the block-uniform tests of l == m,
    l == m + 1 and a dead ring tile all fail)."""
    at = {a: i for i, (a, _) in enumerate(loop)}
    i, n = 0, 1                        # the back edge
    while i < len(loop) - 1:
        n += 1
        txt = loop[i][1]
        m = re.search(r"BRA\s.*0x([0-9a-f]+)", txt)
        if m and not txt.startswith("@"):
            if at.get(int(m.group(1), 16), -1) <= i:
                break
            i = at[int(m.group(1), 16)]
            continue
        i += 1
    return n


def _reduce_rows(dev):
    """(what, part, reduce) of every anal_reduce shape the main paths give
    it, per (grid, rings, l_max, K, variant, spin): the plain grid's rows
    and the slot layout's streams (their dead tails zero, as the analysis
    kernels write them); ``reduce(tree)`` is the call of ``tree``'s own
    wrapper on that route."""
    from repro_torch.core import legendre as cleg
    from repro_torch.kernels import pack as kpack
    gen = torch.Generator(device=dev).manual_seed(0)
    for grid, R, l_max, K, var, spins in (
            ("GL 4096", 4097, 4096, 1, "vpu", (0, 2)),
            ("GL 2048", 2049, 2048, 8, "mxu", (0, 2)),
            ("HEALPix 1024", 4095, 2048, 8, "mxu", (0, 2)),
            ("HEALPix 2048", 8191, 4096, 1, "vpu", (0,)),
            ("GL 1024", 1025, 1024, 1, "vpu", (0, 2)),
            ("GL 1024", 1025, 1024, 8, "mxu", (0, 2))):
        n_ch = -(-R // lc.ANAL_CHUNK[var])
        m = np.arange(l_max + 1)
        for spin in spins:
            rows, mp = (m, None) if spin == 0 else cleg._spin_rows(m)
            lo = kpack.build_layout(rows, l_max, lp_size=ops.PACK_LP_SIZE,
                                    mp_vals=mp)
            m_t = torch.as_tensor(rows, dtype=torch.int32, device=dev)
            mp_t = None if mp is None else torch.as_tensor(
                mp, dtype=torch.int32, device=dev)
            what = f"{grid} K {K} spin {spin}, {n_ch} chunks"
            plain = torch.rand((len(rows), n_ch, l_max + 1, 2 * K),
                               generator=gen, device=dev)
            yield (f"plain {what}", plain, lambda tree: lambda: (
                tree.lc.anal_reduce(plain, m_t, l_max=l_max, mp_vals=mp_t)))
            part = torch.rand((lo.n_slots, n_ch, lo.S, 2 * K), generator=gen,
                              device=dev)
            dead = torch.as_tensor(lo.a_row < 0, device=dev)
            part.masked_fill_(dead[:, None, :, None], 0.0)
            maps = ops._pack_maps(lo, dev)
            yield (f"slot {what}", part, lambda tree: functools.partial(
                _slot_reduce(tree), part, maps, l_max, bool(spin)))


def _path_inputs(grid, size, spin, layout, K=1, var="vpu"):
    """``chip_smoke.py``'s own main path of ``var`` on ``layout`` (its
    seeds, so the analysis digests below are the ones its log prints):
    (plan, pack operands, analysis tables or None, S, analysis rows as the
    kernel takes them, packed coefficient rows)."""
    plan, alm, maps = cs.run_main_path(dev, f"cuda_{var}", size, K, layout,
                                       spin, grid)
    if layout == "fused":
        _, kw, _ = plan._fused_parts(var, False)
        lo, store = kw["lo"], kw["store"]
        pk = store["prep"]
        x = pk[1]
        w = torch.as_tensor(plan.grid.weights, dtype=torch.float32,
                            device=dev)
        fp = fused._anal_rows(cs.path_maps(plan, maps) * w[:, None, None],
                              plan._rows[0], n=getattr(plan.phase, "n", None),
                              fold_rings=None, n_half=x.shape[0],
                              spin=bool(spin),
                              bucket=getattr(plan.phase, "index", None))
        f = ops._pack_rows(fp, lo)
        tab = store[("tables", "anal")]
    else:
        store = plan._fused_store
        lo, pk = store["layout"], store["prep"]
        _, dw = cs.path_rows(plan, alm, maps)
        f = ops._pack_rows(dw, lo).reshape(lo.n_slots, 2, pk[1].shape[0],
                                           dw.shape[-1])
        tab = None
    # the vpu kernels take the rows channel-major
    f = (f.movedim(-1, f.dim() - 2) if var == "vpu" else f).contiguous()
    a_rows = plan._eb_rows(alm) if spin else torch.cat([alm.real, alm.imag],
                                                        dim=-1)
    return plan, pk, tab, lo.S, f, ops._pack_a(a_rows, lo).contiguous()


#: (grid, size, spin, layout) of the main paths whose vpu kernels
#: ``--compare`` runs on their own inputs: the fused ones time kernels 9,
#: 11 and 7, the packed GL 4096 ones kernel 5, the plain ones kernel 3;
#: the packed GL 1024 ones (the smoke's packed size) print kernel 7's
#: digests
VPU_PATHS = (("gl", 4096, 0, "fused"), ("gl", 4096, 2, "fused"),
             ("healpix", 2048, 0, "fused"), ("gl", 4096, 0, "packed"),
             ("gl", 4096, 2, "packed"), ("gl", 1024, 0, "packed"),
             ("gl", 1024, 2, "packed"), ("gl", 4096, 0, "plain"),
             ("gl", 4096, 2, "plain"))


def _same_and_turns(what, old, new):
    """A synthesis of both trees: digests, bit equality, times in turns."""
    a, b = old(), new()
    what = (f"{what}: digests {cs.digest(a)} -> {cs.digest(b)}, bit-equal "
            f"{torch.equal(a, b)}")
    del a, b
    return _turns(what, old, new)


def _compare_plain(old, new, size, spin, var="vpu", grid="gl", K=1):
    """Kernel 3 (``anal_vpu``) or 4 (``anal_mxu``) on ``chip_smoke.py``'s
    plain main path: both trees' reduced outputs (digests, gap) and the
    partials kernel timed in turns."""
    plan, alm, maps = cs.run_main_path(dev, f"cuda_{var}", size, K, "plain",
                                       spin, grid)
    m_t, x, pmm, pms, mp_t = plan._row_seeds()
    _, dw = cs.path_rows(plan, alm, maps)
    kw = dict(l_max=plan.l_max, mp_vals=mp_t)
    ro, rn = (getattr(tree.lc, f"anal_{var}")(dw, m_t, x, pmm, pms, **kw)
              for tree in (old, new))
    torch.cuda.synchronize()
    gap = float((ro - rn).abs().max() / ro.abs().max())
    what = (f"anal_{var} plain path {cs.where(plan)} K {K} spin {spin}: "
            f"digests {cs.digest(ro)} -> {cs.digest(rn)}, trees differ by "
            f"{gap:.3e} of max|parent|")
    if var == "vpu":
        # the plain reduce of each tree's partials (the smoke's
        # anal_reduce line prints its digest beside the kernel's)
        po, pn = (kref.anal_reduce_ref(tree.lc.anal_partials(
            "vpu", dw, m_t, x, pmm, pms, **kw), m_t, **kw)
            for tree in (old, new))
        print(f"  plain reduce of kernel 3's partials, {cs.where(plan)} K 1 "
              f"spin {spin}: digests {cs.digest(po)} -> {cs.digest(pn)}, "
              f"trees differ by "
              f"{float((po - pn).abs().max() / po.abs().max()):.3e} of "
              "max|parent|", flush=True)
        del po, pn
    del ro, rn
    _turns(what, *(functools.partial(tree.lc.anal_partials, var, dw, m_t,
                                     x, pmm, pms, **kw)
                   for tree in (old, new)))
    print(f"    SM clock, max: {_clocks()}", flush=True)
    del plan, alm, maps, dw
    torch.cuda.empty_cache()


def _phase2_anal_vpu(old, new):
    """Kernel 3 on ``chip_smoke.py``'s phase-2 operands
    (``check_cases``): both trees' digests, as its log prints them, and
    the gap between them."""
    for spin in (False, True):
        for fold, K, seeds, kw, _, dw in cs.check_cases(dev, spin,
                                                        cs.check_gen(spin)):
            ro, rn = (tree.lc.anal_vpu(dw, *seeds, **kw)
                      for tree in (old, new))
            gap = float((ro - rn).abs().max() / ro.abs().max())
            print(f"  anal_vpu{cs.tag(spin)} l_max {kw['l_max']} "
                  f"fold={fold!s:5s} K={K}: digests {cs.digest(ro)} -> "
                  f"{cs.digest(rn)}, trees differ by {gap:.3e} of "
                  "max|parent|", flush=True)


def compare_vpu(old, new):
    """The vpu kernels (9, 11, 7, 5, 3) and ``anal_reduce``, parent
    against this tree."""
    print("anal_reduce, each tree through its own wrapper (bits: this "
          "tree's output against the parent's; host: us a call, calls "
          "queued back to back):", flush=True)
    for what, part, reduce in _reduce_rows(dev):
        a, b = reduce(old)(), reduce(new)()
        torch.cuda.synchronize()
        _turns(f"{what}, {tuple(part.shape)}: bit-equal "
               f"{torch.equal(a, b)}", reduce(old), reduce(new))
        lib = lambda: part.sum(dim=1)  # noqa: E731
        print(f"    part.sum(dim=1) {cs.cuda_time_ms(lib):.4f} ms; host "
              f"parent {host_us(reduce(old)):.1f}, this tree "
              f"{host_us(reduce(new)):.1f}, part.sum {host_us(lib):.1f}",
              flush=True)
        del part, a, b
    torch.cuda.empty_cache()
    print("kernel 3 on chip_smoke.py's phase-2 operands:", flush=True)
    _phase2_anal_vpu(old, new)
    print("vpu kernels, on chip_smoke.py's main-path inputs (digests of "
          "the reduced analysis and of the synthesis, as its log prints "
          "them):", flush=True)
    for grid, size, spin, layout in VPU_PATHS:
        if layout == "plain":
            _compare_plain(old, new, size, spin)
            continue
        plan, pk, tab, S, f, a_pk = _path_inputs(grid, size, spin, layout)
        sp = bool(spin)
        where = f"{cs.where(plan)} K 1 spin {spin}"
        # the fused path's rows through both kernels (kernel 7 without
        # tables), the packed path's through kernel 7 (its digests only)
        for kind in (("fused", "packed") if layout == "fused"
                     else ("packed",) if size < 4096 else ()):
            t = (tab,) if kind == "fused" else ()
            kw = dict(l_max=plan.l_max, s_len=S, spin=sp)

            def run(tree, reduced=False):
                if reduced:
                    return getattr(tree.fc, f"anal_{kind}_vpu")(f, *pk, *t,
                                                                **kw)
                fn = getattr(tree.fc, f"anal_{kind}_partials")
                return lambda: fn("vpu", f, *pk, *t, **kw)

            ro, rn = run(old, True), run(new, True)
            torch.cuda.synchronize()
            gap = float((ro - rn).abs().max() / ro.abs().max())
            what = (f"anal_{kind}_vpu {layout} path {where}, tables "
                    f"{'applied' if tab is not None and t else 'none'}: "
                    f"digests {cs.digest(ro)} -> {cs.digest(rn)}, trees "
                    f"differ by {gap:.3e} of max|parent|")
            del ro, rn
            if layout != "fused":
                print(f"  {what}", flush=True)
                continue
            _turns(what, run(old), run(new))
            print(f"    SM clock, max: {_clocks()}", flush=True)
        if layout == "fused" or size == 4096:
            # kernel 9 on the fused paths (their synthesis tables), kernel
            # 5 on the packed GL 4096 ones
            kind = "fused" if layout == "fused" else "packed"
            t = ((plan._fused_store[("tables", "synth")],)
                 if layout == "fused" else ())
            _same_and_turns(f"synth_{kind}_vpu {layout} path {where}", *(
                functools.partial(getattr(tree.fc, f"synth_{kind}_vpu"),
                                  a_pk, *pk, *t, l_max=plan.l_max, spin=sp)
                for tree in (old, new)))
        del plan, f, a_pk
        torch.cuda.empty_cache()
    print("kernel 9 at more maps (plans pick the vpu variant for K 1-7): "
          "map chunks of 4 and 8", flush=True)
    for K in (4, 7):
        plan, pk, _, _, _, a_pk = _path_inputs("gl", 4096, 0, "fused", K)
        _same_and_turns(
            f"synth_fused_vpu fused path {cs.where(plan)} K {K} spin 0", *(
                functools.partial(tree.fc.synth_fused_vpu, a_pk, *pk,
                                  plan._fused_store[("tables", "synth")],
                                  l_max=plan.l_max, spin=False)
                for tree in (old, new)))
        del plan, pk, a_pk
        torch.cuda.empty_cache()
    print("the packed layout at GL 4096/K1 (chip_smoke.py's main_path, which "
          "the smoke itself runs at l_max 1024):", flush=True)
    for spin in (0, 2):
        cs.main_path(dev, "cuda_vpu", 4096, 1, "packed", spin)


#: (grid, size, spin, layout) of the mxu main paths whose analyses
#: ``--compare`` runs on their own inputs: kernel 12 on the fused ones (and
#: its bf16 instantiation on ``chip_smoke.py``'s BF16_PATHS), kernel 8 on
#: the packed GL 2048 ones (at full width: the smoke runs the packed layout
#: at l_max 1024), kernel 4 on the plain ones
MXU_PATHS = tuple((grid, size, spin, layout)
                  for layout in ("fused", "packed", "plain")
                  for grid, size in (("gl", 2048), ("healpix", 1024))
                  for spin in (0, 2)
                  if layout != "packed" or grid == "gl")


def _ptxas(pattern=r"anal_(?:fused_)?mxu_kernelI\w+?EE"):
    """Registers and spills of every instantiation whose name matches
    ``pattern`` (default: the mxu analyses), from both trees' ``-Xptxas
    -v`` logs."""
    for pre in ("parent_", ""):
        for lib in build.SOURCES:
            path = f"chiprun_out/ptxas_{pre}{lib}.log"
            if not os.path.exists(path):
                continue
            with open(path) as fh:
                blocks = fh.read().split("Compiling entry function '")[1:]
            for block in blocks:
                name = re.search(pattern, block.split("'")[0])
                if not name:
                    continue
                regs = re.search(r"Used (\d+) registers", block)
                spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                  r"spill stores, (\d+) bytes spill loads",
                                  block)
                print(f"  {'parent' if pre else 'tree'} {name.group(0)}: "
                      f"{regs.group(1) if regs else '?'} registers, stack "
                      f"frame/spill stores/spill loads "
                      f"{spill.groups() if spill else '?'}", flush=True)


def _phase2_outputs(tree) -> dict:
    """Every kernel output ``chip_smoke.py``'s phase 2 holds against a plain
    version (staged, fused, packed and bf16 checks at CHECK_L_MAX, spin 0
    and 2), computed through ``tree``'s kernels on the smoke's own operands:
    {(name, what): output on the CPU}."""
    got = {}

    def held(name, out, want, what, pad=None, tol=cs.KERNEL_TOL):
        got[(name, what)] = out.detach().cpu()
        return 0.0

    saved = (cs.lc, cs.fused_cuda, cs.held, cs.log, cs.cuda_time_ms)
    cs.lc, cs.fused_cuda, cs.held = tree.lc, tree.fc, held
    cs.log, cs.cuda_time_ms = (lambda msg: None), (lambda fn, reps=5: 0.0)
    try:
        for spin in (False, True):
            for check in (cs.check_kernels, cs.check_fused_kernels,
                          cs.check_packed_kernels, cs.check_bf16_kernels):
                check(dev, spin)
    finally:
        cs.lc, cs.fused_cuda, cs.held, cs.log, cs.cuda_time_ms = saved
    return got


def _compare_phase2(old, new):
    """chip_smoke.py's phase-2 outputs of both trees: each one that moved,
    with both digests and its gap as a share of max|parent|."""
    po, pn = _phase2_outputs(old), _phase2_outputs(new)
    same = 0
    for key, b in pn.items():
        a = po[key]
        if torch.equal(a, b):
            same += 1
            continue
        gap = float((a - b).abs().max() / a.abs().max())
        print(f"  {key[0]} {key[1]}: digests {cs.digest(a)} -> "
              f"{cs.digest(b)}, trees differ by {gap:.3e} of max|parent|",
              flush=True)
    print(f"  {same} of {len(pn)} phase-2 outputs bit-equal to the "
          "parent's", flush=True)


def compare_mxu(old, new):
    """The mxu analysis kernels (12 with its bf16 instantiation, 8, 4) on
    chip_smoke.py's phase-2 operands and on their main paths, then kernel
    11 at GL 4096 with K 4 and 7, parent against this tree."""
    _ptxas()
    print("chip_smoke.py's phase 2 through both trees:", flush=True)
    _compare_phase2(old, new)
    print("mxu analysis kernels, on chip_smoke.py's main-path inputs "
          "(digests of the reduced analysis, as its log prints them):",
          flush=True)
    for grid, size, spin, layout in MXU_PATHS:
        if layout == "plain":
            _compare_plain(old, new, size, spin, "mxu", grid, 8)
            continue
        plan, pk, tab, S, f, _ = _path_inputs(grid, size, spin, layout, 8,
                                              "mxu")
        where = f"{cs.where(plan)} K 8 spin {spin}"
        t = (tab,) if layout == "fused" else ()
        bf16s = ((False, True) if layout == "fused"
                 and (grid, size, 8, spin) in cs.BF16_PATHS else (False,))
        for bf16 in bf16s:
            kw = dict(l_max=plan.l_max, s_len=S, spin=bool(spin),
                      **({"bf16": True} if bf16 else {}))

            def run(tree, reduced=False):
                if reduced:
                    return getattr(tree.fc, f"anal_{layout}_mxu")(f, *pk, *t,
                                                                  **kw)
                fn = getattr(tree.fc, f"anal_{layout}_partials")
                return lambda: fn("mxu", f, *pk, *t, **kw)

            ro, rn = run(old, True), run(new, True)
            torch.cuda.synchronize()
            gap = float((ro - rn).abs().max() / ro.abs().max())
            _turns(f"anal_{layout}_mxu{'_bf16' if bf16 else ''} {layout} "
                   f"path {where}, tables "
                   f"{'applied' if tab is not None and t else 'none'}: "
                   f"digests {cs.digest(ro)} -> {cs.digest(rn)}, trees "
                   f"differ by {gap:.3e} of max|parent|", run(old), run(new))
            print(f"    SM clock, max: {_clocks()}", flush=True)
            del ro, rn
        del plan, pk, tab, f
        torch.cuda.empty_cache()
    print("kernel 11 at more maps (plans pick the vpu variant for K 1-7): "
          "map chunks of 2, both trees", flush=True)
    for K in (4, 7):
        plan, pk, tab, S, f, _ = _path_inputs("gl", 4096, 0, "fused", K)
        kw = dict(l_max=plan.l_max, s_len=S, spin=False)
        ro, rn = (tree.fc.anal_fused_vpu(f, *pk, tab, **kw)
                  for tree in (old, new))
        torch.cuda.synchronize()
        _turns(f"anal_fused_vpu fused path {cs.where(plan)} K {K} spin 0: "
               f"bit-equal {torch.equal(ro, rn)}", *(
                   functools.partial(tree.fc.anal_fused_partials, "vpu", f,
                                     *pk, tab, **kw) for tree in (old, new)))
        del plan, pk, tab, f, ro, rn
        torch.cuda.empty_cache()


def _triples(plan) -> int:
    """(row, l >= l0, ring) triples of a plan's Legendre stage."""
    m_t, x, _, _, mp_t = plan._row_seeds()
    return cs.legendre_work(m_t.cpu().numpy(), plan.l_max + 1, x.shape[0],
                            2 * plan.K, None if mp_t is None
                            else mp_t.cpu().numpy())[0]


def _issue(tree_ms, triples, kernel):
    """This tree's share of the issue rate on a path: the SASS instructions
    a triple of instantiation ``kernel`` (``_sass_report``) x the path's
    triples over 132 SMs x 128 lanes x the SM clock under load, over its
    time."""
    clock = _clocks()
    mhz = float(clock.split(",")[0].split()[0])
    per = PER_TRIPLE.get(("tree", kernel))
    rate = 132 * 128 * mhz * 1e6           # SASS instructions a second
    share = ("?" if per is None else
             f"{per * triples / rate / (tree_ms * 1e-3):.0%}")
    print(f"    {triples:.4g} triples, {per} SASS a triple ({kernel}), "
          f"{share} of the issue rate; SM clock, max: {clock}", flush=True)


#: the plain paths of the staged synthesis: (grid, size, spin, K); K 8
#: runs kernel 2 (``synth_mxu``), K < 8 kernel 1 (``synth_vpu``)
SYNTH_PLAIN = (("gl", 2048, 0, 8), ("gl", 2048, 2, 8),
               ("healpix", 1024, 0, 8), ("healpix", 1024, 2, 8),
               ("gl", 4096, 0, 1), ("gl", 4096, 2, 1), ("gl", 4096, 0, 4),
               ("gl", 4096, 0, 7))


def compare_synth(old, new):
    """The synthesis kernels (2; 1, 10 with its bf16 instantiation, 6, 9
    and 5 as the controls), parent against this tree, on chip_smoke.py's
    phase-2 operands and main-path inputs; then the plan-level outputs of
    chip_smoke.py's packed and ragged-grid paths through both trees."""
    _ptxas(r"synth_\w*?kernelI\w+?EE")
    print("chip_smoke.py's phase 2 through both trees:", flush=True)
    _compare_phase2(old, new)
    print("synthesis kernels on chip_smoke.py's main-path inputs (bits: "
          "this tree's output against the parent's):", flush=True)
    for grid, size, spin, K in SYNTH_PLAIN:
        var = "mxu" if K == 8 else "vpu"
        plan, alm, maps = cs.run_main_path(dev, f"cuda_{var}", size, K,
                                           "plain", spin, grid)
        m_t, x, pmm, pms, mp_t = plan._row_seeds()
        a, _ = cs.path_rows(plan, alm, maps)
        kw = dict(l_max=plan.l_max, mp_vals=mp_t)
        what = f"synth_{var} plain path {cs.where(plan)} K {K} spin {spin}"
        _, pn = _same_and_turns(what, *(
            functools.partial(getattr(tree.lc, f"synth_{var}"), a, m_t, x,
                              pmm, pms, **kw) for tree in (old, new)))
        if K in (1, 8):
            _issue(pn, _triples(plan), f"synth_{var}_kernelILi"
                   f"{2 * K if K == 1 else 16}ELb0ELb{int(bool(spin))}EE")
        del plan, alm, maps, a
        torch.cuda.empty_cache()
    for grid, size, spin, layout in MXU_PATHS:
        if layout == "plain":
            continue
        plan, pk, _, _, _, a_pk = _path_inputs(grid, size, spin, layout, 8,
                                               "mxu")
        tab = (plan._fused_store[("tables", "synth")],) \
            if layout == "fused" else ()
        where = f"{cs.where(plan)} K 8 spin {spin}"
        bf16s = ((False, True) if layout == "fused"
                 and (grid, size, 8, spin) in cs.BF16_PATHS else (False,))
        for bf16 in bf16s:
            kw = dict(l_max=plan.l_max, spin=bool(spin),
                      **({"bf16": True} if bf16 else {}))
            name = f"synth_{layout}_mxu{'_bf16' if bf16 else ''}"
            what = (f"{name} {layout} path {where}, tables "
                    f"{'applied' if tab and tab[0] is not None else 'none'}")
            _, pn = _same_and_turns(what, *(
                functools.partial(getattr(tree.fc, f"synth_{layout}_mxu"),
                                  a_pk, *pk, *tab, **kw)
                for tree in (old, new)))
            _issue(pn, _triples(plan), "synth_fused_mxu_kernelILi8ELb0ELb1E"
                   f"Lb{int(bool(spin))}ELb{int(bf16)}EE")
        del plan, pk, a_pk
        torch.cuda.empty_cache()
    print("kernels 9 and 5 (the template moved into recurrence.cuh):",
          flush=True)
    for layout in ("fused", "packed"):
        for spin in (0, 2):
            plan, pk, _, _, _, a_pk = _path_inputs("gl", 4096, spin, layout)
            tab = (plan._fused_store[("tables", "synth")],) \
                if layout == "fused" else ()
            _same_and_turns(
                f"synth_{layout}_vpu {layout} path {cs.where(plan)} K 1 "
                f"spin {spin}", *(
                    functools.partial(getattr(tree.fc, f"synth_{layout}_vpu"),
                                      a_pk, *pk, *tab, l_max=plan.l_max,
                                      spin=bool(spin))
                    for tree in (old, new)))
            del plan, pk, a_pk
            torch.cuda.empty_cache()
    print("plan-level outputs of chip_smoke.py's packed and ragged-grid "
          "paths, both directions through both trees:", flush=True)
    _compare_plans(old, new)


#: (grid, size, mode, K, layout, spins) of ``chip_smoke.py``'s paths whose
#: plan-level outputs no other part of ``--compare`` reaches: its packed
#: paths (l_max 1024) and its ragged-grid paths
OTHER_PATHS = tuple(("gl", l_max, mode, K, layout, cs.SPINS)
                    for mode, l_max, K, layout in cs.MAIN_PATH
                    if layout == "packed") + cs.RAGGED_PATHS


@contextlib.contextmanager
def _kernels_of(tree):
    """Route every plan's kernel calls through ``tree``'s wrappers: the
    plans reach them as ``repro_torch.kernels.legendre_cuda`` and
    ``.fused_cuda``, imported where they launch."""
    import repro_torch.kernels as pkg
    names = ("legendre_cuda", "fused_cuda")
    saved = [getattr(pkg, n) for n in names]
    for n, mod in zip(names, (tree.lc, tree.fc)):
        setattr(pkg, n, mod)
    try:
        yield
    finally:
        for n, mod in zip(names, saved):
            setattr(pkg, n, mod)


def _compare_plans(old, new):
    """``alm2map`` and ``map2alm`` (one analysis) of each of OTHER_PATHS on
    ``chip_smoke.py``'s own plan and inputs, through both trees' kernels:
    both digests, whether they are equal bit for bit, and the gap as a
    share of max|parent|."""
    for grid, size, mode, K, layout, spins in OTHER_PATHS:
        for spin in spins:
            plan, alm, maps = cs.run_main_path(dev, mode, size, K, layout,
                                               spin, grid)
            for direction, fn in (("alm2map", lambda: plan.alm2map(alm)),
                                  ("map2alm", lambda: plan.map2alm(maps))):
                outs = []
                for tree in (old, new):
                    with _kernels_of(tree):
                        outs.append(fn())
                torch.cuda.synchronize()
                a, b = (torch.view_as_real(o) if o.is_complex() else o
                        for o in outs)
                gap = float((a - b).abs().max() / a.abs().max())
                print(f"  {mode} [{layout}] spin {spin} {cs.where(plan)} K "
                      f"{K} {direction}: digests {cs.digest(a)} -> "
                      f"{cs.digest(b)}, bit-equal {torch.equal(a, b)}, trees "
                      f"differ by {gap:.3e} of max|parent|", flush=True)
                del outs, a, b
            del plan, alm, maps
            torch.cuda.empty_cache()


def compare(parts):
    old, new = trees["parent"], trees["this tree"]
    for lib in build.SOURCES:
        _sass_report(libs["parent"][lib], libs["this tree"][lib], lib)
    if "vpu" in parts:
        compare_vpu(old, new)
    if "mxu" in parts:
        compare_mxu(old, new)
    if "synth" in parts:
        compare_synth(old, new)
    print("total s", time.time() - t0, flush=True)


def _clocks():
    """The card's SM clock now and its maximum, as nvidia-smi reports."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


if "--compare" in sys.argv:
    compare([a for a in sys.argv[sys.argv.index("--compare") + 1:]
             if a in ("vpu", "mxu", "synth")] or ["vpu", "mxu", "synth"])
    sys.exit(0)

if "--first-calls" in sys.argv:
    print("cufft plan cache max size",
          torch.backends.cuda.cufft_plan_cache.max_size, flush=True)
    first_calls(1024, 8)
    first_calls(2048, 1)
    sys.exit(0)

l_max = 256
for spin in (False, True):
    gen = torch.Generator().manual_seed(3)
    m_vals, mp_vals, lo = cs.test_layout(l_max, spin)
    for fold in ((False,) if spin else (False, True)):
        _, x, pmm, pms = cs.seeds_for(l_max, m_vals, fold, dev, mp_vals)
        maps, x, pmm_pk, pms_pk = ops._prep(lo, x, pmm, pms)
        R, P = x.shape[0], (2 if fold else 1)
        for K in (1, 2, 3, 8):
            K2 = 2 * K
            a_pk = ops._pack_a(cs.random_a(gen, m_vals, l_max + 1, K2, dev, mp_vals), lo).contiguous()
            f = (torch.rand((lo.n_slots, 2, P, R, K2), generator=gen) * 2 - 1).to(dev)
            tab = (torch.rand((lo.n_slots, 2, P, 4, R), generator=gen) * 2 - 1).to(dev)
            for t in (tab, None):
                ws = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max, fold=fold, spin=spin, bf16=True)
                wa = kref.anal_fused_ref(f, maps, x, pmm_pk, pms_pk, t, l_max=l_max, s_len=lo.S, spin=spin, bf16=True)
                w32 = kref.synth_fused_ref(a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max, fold=fold, spin=spin)
                gs = fused_cuda.synth_fused_mxu(a_pk, maps, x, pmm_pk, pms_pk, t, l_max=l_max, fold=fold, spin=spin, bf16=True)
                ga = fused_cuda.anal_fused_mxu(f, maps, x, pmm_pk, pms_pk, t, l_max=l_max, s_len=lo.S, spin=spin, bf16=True)
                torch.cuda.synchronize()
                es = float((gs - ws).abs().max() / ws.abs().max()); ea = float((ga - wa).abs().max() / wa.abs().max())
                e32 = float((ws - w32).abs().max() / w32.abs().max())
                print(f"spin={spin} fold={fold} K={K} tab={t is not None}: synth {es:.3e} anal {ea:.3e} (bf16 vs f32 plain {e32:.3e})", flush=True)
print(fused_cuda.launches)
# bucket path at nside 64
for spin in (0, 2):
    for lay in ("fused", "plain", "packed"):
        p = repro_torch.make_plan("healpix", nside=64, K=4, dtype="float32", spin=spin, layout=lay)
        pc = repro_torch.make_plan("healpix", nside=64, K=4, dtype="float32", spin=spin, layout=lay, device="cpu")
        rng = np.random.default_rng(0); shp = p._alm_shape
        a = rng.normal(size=shp) + 1j * rng.normal(size=shp)
        mask = np.arange(p.l_max + 1)[None, :] >= np.maximum(np.arange(p.m_max + 1), spin)[:, None]
        a = (a * mask[..., None]).astype(np.complex64)
        m1 = p.alm2map(torch.as_tensor(a, device=dev)); m2 = p.alm2map(torch.as_tensor(a, device=dev))
        mc = pc.alm2map(torch.as_tensor(a))
        b1 = p.map2alm(m1); bc = pc.map2alm(mc)
        torch.cuda.synchronize()
        print(f"healpix 64 spin {spin} {lay}: rerun equal {torch.equal(m1, m2)}, vs cpu plain synth {float((m1.cpu()-mc).abs().max()/mc.abs().max()):.3e} anal {float((b1.cpu()-bc).abs().max()/bc.abs().max()):.3e}", flush=True)
# bucket phase timing at full width
for nside, K in ((1024, 8), (2048, 1)):
    t = time.time()
    p = repro_torch.make_plan("healpix", nside=nside, K=K, dtype="float32")
    ph = p.phase
    print("plan + phase build s", time.time() - t, flush=True)
    d = torch.randn(p.m_max + 1, p.grid.n_rings, K, dtype=torch.complex64, device=dev)
    mp = ph.synth(d)
    print(f"nside {nside} K {K}: bucket synth ms {cs.cuda_time_ms(lambda: ph.synth(d)):.2f} host {cs.host_ms(lambda: ph.synth(d)):.2f}; anal ms {cs.cuda_time_ms(lambda: ph.anal(mp)):.2f} host {cs.host_ms(lambda: ph.anal(mp)):.2f}", flush=True)
    a = torch.randn(p._alm_shape, dtype=torch.complex64, device=dev)
    t = time.time(); m = p.alm2map(a); torch.cuda.synchronize(); print("first alm2map s", time.time() - t, flush=True)
    print(f"  fused alm2map host ms {cs.host_ms(lambda: p.alm2map(a)):.2f} map2alm {cs.host_ms(lambda: p.map2alm(m)):.2f}", flush=True)
    print(torch.cuda.max_memory_allocated() / 1e9, "GB peak", flush=True)
print("total s", time.time() - t0)
