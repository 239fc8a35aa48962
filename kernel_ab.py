#!/usr/bin/env python3
"""The hand-written kernels of this checkout against another's on one card,
and the build report of this checkout's kernels.

    python3 kernel_ab.py [--parent DIR] [--only-k1] [--parent-k1-lib]
                         [--out PATH]

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
and ``cuobjdump`` (``CUDA_HOME`` or ``/usr/local/cuda``). ``DIR`` is the
root of another checkout of the repository (for example an unpacked
``git archive`` of an earlier commit).

1. report: compiles ``csrc/wna16_gemm.cu``, ``paged_chunk.cu``,
   ``paged_attention_mla.cu`` and ``paged_attention.cu`` to sm_90a cubins
   with ``-Xptxas -v`` and prints, for each kernel, its registers, its
   spill stores and loads and its count of tensor-core instructions (HMMA /
   HGMMA) in ``cuobjdump -sass``; with ``--parent`` the same for the
   parent's sources, and for each main-path instantiation whether its SASS
   (addresses and constant-bank offsets masked) is the parent's, line for
   line;
2. cases: chip_smoke.py's kernel cases of the wNa16 GEMM (K1), the decode
   walk (K2, K2-q, with its engine-shaped cases), the chunk walk (K3,
   K3-q) and its latent mode (K3-mla), each held against its plain version and timed as
   chip_smoke.py times it (CUDA-event medians, L2 flushed), in one child
   process per run; the table compares the kernel's times only. With
   ``--parent`` the runs go parent, this, this, parent, each child
   importing the port from its own checkout; a case a checkout refuses is
   recorded as refused. ``--only-k1`` runs K1's cases alone;
   ``--parent-k1-lib`` adds two runs of this checkout with the parent's
   K1 library in place of its own (parent, this, this + parent's K1,
   this + parent's K1, this, parent), which tells the kernel's code from
   the host's side of a difference.

Prints the card's name and power limit, the report and a table of kernel
ms per run, and writes all of it to ``--out`` (JSON). Exits non-zero when
there is no CUDA device, a build fails or a case disagrees with its plain
version.
"""
from __future__ import annotations

import argparse
import collections
import difflib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPORT_SOURCES = ("wna16_gemm", "paged_chunk", "paged_attention_mla",
                  "paged_attention")
# the instantiations of the main path: K1 at decode and prefill M (bf16 x,
# int4, the 16-byte build), K2 / K2-q and K3 / K3-q (bf16 q, float32 pool)
# and K3-mla (float32 q and pool)
MIX_KERNELS = ("wna16_kernel<bf16, 4, 8, 8, 0, 0>",
               "wna16_kernel<bf16, 4, 64, 8, 0, 0>",
               "paged_decode_kernel<bf16, float, 128, 0>",
               "paged_decode_kernel<bf16, float, 128, 1>",
               "paged_chunk_kernel<bf16, float, 128, 128, 0>",
               "paged_chunk_kernel<bf16, float, 128, 128, 1>",
               "paged_chunk_kernel<float, float, 576, 512, 0>")


def log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_bin(tool: str) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / tool
    return str(cand) if cand.exists() else (shutil.which(tool) or tool)


def _start_build(tree: Path) -> subprocess.Popen:
    """Build a checkout's kernels in a child (its own build directory)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; print(build.build_all())")
    return subprocess.Popen([sys.executable, "-c", code, str(tree / "src")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _short(name: str) -> str:
    """A kernel's demangled name cut to its template arguments."""
    name = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", name)
    name = name.replace("__nv_bfloat16", "bf16").replace("__half", "f16")
    name = re.sub(r"\((int|bool|unsigned int)\)", "", name)
    return re.sub(r"\([^()]*\)$", "", name).replace("void ", "").strip()


def _masked(lines) -> list:
    """SASS lines without their addresses, encodings and constant-bank
    offsets (which move with a struct's size, not with the code)."""
    out = []
    for line in lines:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m:
            out.append(re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[..]",
                              m.group(1)))
    return out


def report(tmp: Path, tree: Path = ROOT) -> list:
    """Registers, spills and tensor-core instructions of every kernel of
    ``REPORT_SOURCES`` in ``tree`` (compiled with the build's flags to
    cubins), and the masked SASS of each."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = {}
    for name in REPORT_SOURCES:
        cubin = tmp / f"{name}.cubin"
        cmd = [build.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-o",
               str(cubin), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       cubin)
    rows = []
    filt = _cuda_bin("cu++filt")
    for name, (proc, cubin) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -cubin {name}.cu failed:\n{out}")
        info, cur = {}, None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = m.group(1)
                info[cur] = {"regs": None, "spill_stores": None,
                             "spill_loads": None}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and cur:
                info[cur]["spill_stores"] = int(m.group(1))
                info[cur]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                info[cur]["regs"] = int(m.group(1))
        sass = subprocess.run([_cuda_bin("cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True
                              ).stdout
        mma, ops, text, cur = {}, {}, collections.defaultdict(list), None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1)
                mma[cur] = 0
                ops[cur] = collections.Counter()
                continue
            if cur:
                text[cur].append(line)
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                          line)
            if cur and m:
                ops[cur][m.group(1)] += 1
                if m.group(1) in ("HMMA", "HGMMA"):
                    mma[cur] += 1
        names = list(info)
        demangled = subprocess.run([filt], input="\n".join(names),
                                   capture_output=True, text=True
                                   ).stdout.splitlines()
        if len(demangled) != len(names):
            demangled = names
        for mangled, pretty in zip(names, demangled):
            top = ops.get(mangled, collections.Counter()).most_common(12)
            rows.append(dict(source=f"{name}.cu", kernel=_short(pretty),
                             tensor_core_instructions=mma.get(mangled, 0),
                             sass_instructions=sum(
                                 ops.get(mangled, {}).values()),
                             top_opcodes=top, sass=_masked(text[mangled]),
                             **info[mangled]))
    return rows


def compare_sass(rows, parent_rows) -> None:
    """Log, for each main-path instantiation, this build's registers and
    instructions beside the parent's and the SASS lines that differ."""
    theirs = {r["kernel"]: r for r in parent_rows}
    for r in rows:
        if r["kernel"] not in MIX_KERNELS:
            continue
        name = r["kernel"]
        if name.startswith("wna16"):   # the parent's K1 has no NARROW flag
            name = re.sub(r", 0>$", ">", name)
        p = theirs.get(name)
        if p is None:
            log(f"  {r['kernel']}: not in the parent's build")
            continue
        diff = [ln for ln in difflib.unified_diff(p["sass"], r["sass"],
                                                  lineterm="", n=0)
                if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
        log(f"  {r['kernel']}: regs {p['regs']} -> {r['regs']}, SASS "
            f"instructions {p['sass_instructions']} -> "
            f"{r['sass_instructions']}, {len(diff)} masked lines differ"
            + (f"; first: {diff[:6]}" if diff else ""))


def child(tree: Path, out: Path, only_k1: bool = False,
          k1_lib: Path = None) -> int:
    """Check and time every kernel case (K1's alone with ``only_k1``) with
    the port of ``tree``, its K1 library replaced by ``k1_lib`` if given."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    if k1_lib is not None:
        build._LIBS["wna16_gemm"] = ctypes.CDLL(str(k1_lib))
    timer = cs.Timer(torch)
    results, refused = [], []

    def each(fn, cases, **kw):
        for case in cases:
            try:
                fn(torch, timer, results, [case], **kw)
            except ValueError as e:      # a case this checkout refuses
                refused.append(dict(case=repr(case), bits=kw.get("bits"),
                                    error=str(e)))
                log(f"  refused {case}: {e}")

    each(cs.wna16_cases, cs.WNA16_CASES)
    if only_k1:
        out.write_text(json.dumps(dict(tree=str(tree), results=results,
                                       refused=refused)))
        return 0
    each(cs.decode_cases, cs.DECODE_CASES)
    each(cs.engine_decode_cases, cs.ENGINE_DECODE_CASES)
    each(cs.chunk_cases, cs.CHUNK_CASES)
    for bits in (8, 4):
        each(cs.decode_cases, cs.DECODE_Q_CASES, bits=bits)
        each(cs.engine_decode_cases, cs.ENGINE_DECODE_Q_CASES, bits=bits)
        each(cs.chunk_cases, cs.CHUNK_Q_CASES, bits=bits)
    cs.mla_chunk_cases(torch, timer, results)
    out.write_text(json.dumps(dict(tree=str(tree), results=results,
                                   refused=refused)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "bench_out" / "kernel_ab.json")
    ap.add_argument("--only-k1", action="store_true")
    ap.add_argument("--parent-k1-lib", action="store_true")
    ap.add_argument("--child", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--child-out", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--k1-lib", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child.resolve(), args.child_out, args.only_k1,
                     args.k1_lib)

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    trees = {"this": ROOT}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    t0 = time.perf_counter()
    builds = {k: _start_build(t) for k, t in trees.items()}
    with tempfile.TemporaryDirectory() as tmp:
        rows = report(Path(tmp))
    parent_rows = []
    if "parent" in trees:
        with tempfile.TemporaryDirectory() as tmp:
            parent_rows = report(Path(tmp), trees["parent"])
    for k, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {k} failed:\n{out}")
        log(f"build {k}: {out.strip().splitlines()[-1]}")
    log(f"builds and report {time.perf_counter() - t0:.1f} s")
    log("kernel | regs | spill stores / loads (bytes) | HMMA/HGMMA | SASS "
        "instructions (static)")
    for r in rows:
        log(f"  {r['source']} {r['kernel']} | {r['regs']} | "
            f"{r['spill_stores']} / {r['spill_loads']} | "
            f"{r['tensor_core_instructions']} | {r['sass_instructions']}")
    for r in rows:     # the instruction mix of the main path's instantiations
        if r["kernel"] in MIX_KERNELS:
            log(f"  {r['kernel']} top opcodes: {r['top_opcodes']}")
    if parent_rows:
        log("main-path instantiations against the parent's build:")
        compare_sass(rows, parent_rows)

    order = ["parent", "this", "this", "parent"] if "parent" in trees \
        else ["this"]
    k1_lib = None
    if args.parent_k1_lib and "parent" in trees:
        k1_lib = next((trees["parent"] / "src" / "repro_torch" / "kernels"
                       / "build").glob("libwna16_gemm-*.so"))
        order = ["parent", "this", "mixed", "mixed", "this", "parent"]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, k in enumerate(order):
            out = Path(tmp) / f"run{i}.json"
            t1 = time.perf_counter()
            cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
                   str(trees["this" if k == "mixed" else k]), "--child-out",
                   str(out)]
            cmd += ["--only-k1"] if args.only_k1 else []
            cmd += ["--k1-lib", str(k1_lib)] if k == "mixed" else []
            rc = subprocess.run(cmd).returncode
            if rc != 0:
                raise RuntimeError(f"run {i} ({k}) failed with rc {rc}")
            run = json.loads(out.read_text())
            run.update(tree=k, seconds=time.perf_counter() - t1)
            runs.append(run)
            log(f"run {i} ({k}) {run['seconds']:.1f} s")
            if k != "parent" and run["refused"]:
                raise AssertionError(f"this checkout refused {run['refused']}")

    cases = []
    for r in runs[0 if order[0] == "this" else 1]["results"]:
        if "ms" in r:        # K1 holds some cases without timing them
            cases.append((r["kernel"], r["case"]))
    table = []
    log("kernel case | ms per run (" + ", ".join(order) + ") | this / parent"
        + (" | this with the parent's K1 / parent" if k1_lib else ""))
    for kernel, case in cases:
        per_run = []
        for run in runs:
            hit = [x for x in run["results"]
                   if x["kernel"] == kernel and x["case"] == case]
            per_run.append(hit[0]["ms"] if hit else None)
        mine = [m for m, k in zip(per_run, order) if k == "this"]
        theirs = [m for m, k in zip(per_run, order)
                  if k == "parent" and m is not None]
        mixed = [m for m, k in zip(per_run, order) if k == "mixed"]
        ratio = (statistics.median(mine) / statistics.median(theirs)
                 if theirs else None)
        mixed_ratio = (statistics.median(mixed) / statistics.median(theirs)
                       if theirs and mixed else None)
        table.append(dict(kernel=kernel, case=case, ms=per_run,
                          this_over_parent=ratio,
                          this_parent_k1_over_parent=mixed_ratio))
        log(f"  {kernel} {case} | "
            + ", ".join("refused" if m is None else f"{m:.4f}"
                        for m in per_run)
            + " | " + ("-" if ratio is None else f"{ratio:.3f}")
            + ("" if mixed_ratio is None else f" | {mixed_ratio:.3f}"))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    def brief(rs):          # the report without its SASS text
        return [{k: v for k, v in r.items() if k != "sass"} for r in rs]

    args.out.write_text(json.dumps(dict(
        card=card, order=order, report=brief(rows),
        parent_report=brief(parent_rows), table=table, runs=runs), indent=1))
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
