"""The qkv-form probe tool (`bench_qkv_form`), or with --stencil the
stencil probe tool (`bench_stencil`), of this checkout against the same
tool of another checkout of the repository, on one card.

    python -m textualdegremoval_tpu_torch.tools.bench_qkv_other --other ROOT \\
        [--stencil]

ROOT is the root of another checkout (a `git archive` of the parent under
build/, say).  Each version's tool runs as `python -m` in a process of its
own, from its own root, so that each builds its csrc/ under its own
build/torch_kernels/ and times its own kernels; the runs take turns other,
this, this, other.  The tool prints each run's case lines, then, for each
source, whether ptxas's report is the same as the other version's (path
hashes and compile times taken out) and this version's report of
csrc/probe_qkv_tma.cu, and last one JSON line: per version, each run's
current, composed and cuDNN ms summed over the tool's four cases (ms per
tool run).  With --stencil: each run's µs per stencil step of every
variant and of the cuDNN step at the tool's default shape, and this
version's report of csrc/probe_stencil.cu.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from textualdegremoval_tpu_torch.tools.bench_flash import ptxas_reports

ROOT = Path(__file__).resolve().parents[2]
FORMS = ("current", "composed", "cudnn")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of another checkout, whose qkv tool is run "
                         "in turns with this one's")
    ap.add_argument("--stencil", action="store_true",
                    help="the stencil probe tool in place of the qkv tool")
    return ap.parse_args(argv)


def tool_run(root: Path) -> list[dict]:
    """One run of the qkv tool of the checkout at `root`; its case lines."""
    res = subprocess.run(
        [sys.executable, "-m", "textualdegremoval_tpu_torch.tools."
         "bench_qkv_form"], cwd=root, capture_output=True, text=True,
        timeout=900, check=True)
    print(res.stdout, end="", flush=True)
    return [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith('{"case": "') and '"current_ms"' in line]


def stencil_run(root: Path) -> dict[str, float]:
    """One run of the stencil tool of the checkout at `root`: {variant or
    "cudnn": µs per step}."""
    res = subprocess.run(
        [sys.executable, "-m", "textualdegremoval_tpu_torch.tools."
         "bench_stencil"], cwd=root, capture_output=True, text=True,
        timeout=900, check=True)
    print(res.stdout, end="", flush=True)
    us = {m[1]: float(m[2]) for m in re.finditer(
        r"(?m)^(\w+)\s+t=\d+ W=\d+ ch=\d+:\s+([\d.]+) us/stencil",
        res.stdout)}
    us["cudnn"] = float(re.search(r"one step:\s+([\d.]+) us",
                                  res.stdout)[1])
    return us


def ptxas_log(root: Path) -> dict[str, str]:
    """The ptxas reports of the library that the tool at `root` built last
    under its build/torch_kernels/."""
    logs = sorted((root / "build" / "torch_kernels").glob("*.log"),
                  key=lambda p: p.stat().st_mtime)
    return ptxas_reports(logs[-1].read_text())


def main(argv=None) -> int:
    args = parse_args(argv)
    other = args.other.resolve()
    sums = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        print(f"== {name} ({other if name == 'other' else ROOT})",
              flush=True)
        root = other if name == "other" else ROOT
        if args.stencil:
            sums[name].append(stencil_run(root))
            continue
        rows = tool_run(root)
        sums[name].append({f: sum(r[f + "_ms"] for r in rows)
                           for f in FORMS})
    mine, theirs = ptxas_log(ROOT), ptxas_log(other)
    for src in sorted(set(mine) | set(theirs)):
        state = ("same" if mine.get(src) == theirs.get(src) else
                 "differs" if src in mine and src in theirs else
                 "only in this version" if src in mine else
                 "only in the other version")
        print(f"ptxas report of {src}: {state}", flush=True)
    src = "probe_stencil.cu" if args.stencil else "probe_qkv_tma.cu"
    print(f"ptxas {src}:\n{mine.get(src)}", flush=True)
    print(json.dumps({"per_step_us" if args.stencil else "per_tool_run_ms":
                      sums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
