"""The kernels of two checkouts, instruction for instruction: which of a
source's kernels kept their SASS, which changed, which are new or gone, and
each kernel's registers and spill bytes (``ptxas -v``) in both.

    python -m rten_tpu_torch.tools.sass_diff [--all] OTHER_CHECKOUT \
        [SOURCE ...]

SOURCE names files of ``rten_tpu_torch/csrc`` without ``.cu`` (default:
every source that includes ``decode_attn_kv_group.cuh``). Both checkouts'
sources are built with the port's nvcc flags, one ``nvcc`` a library, all
started together, into ``rten_tpu_torch/build/sass_diff/``; the SASS comes
from ``cuobjdump -sass``. ``--all`` also prints every kernel of this
checkout with its registers and spills. For the first changed kernel of a
source it prints the first lines that differ. Needs nvcc and cuobjdump, no
card. Exits non-zero if a kernel of both checkouts changed.
"""

from __future__ import annotations

import difflib
import re
import shutil
import subprocess
import sys
from pathlib import Path

from rten_tpu_torch.kernels import _build

OUT = _build.BUILD_DIR / "sass_diff"
KV_GROUP = ("decode_attn_paged", "decode_attn_grouped_int8",
            "decode_attn_float", "verify_attn", "decode_attn_append",
            "decode_attn_split")
ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PROPS = re.compile(r"Function properties for (\S+)")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")
FUNC = re.compile(r"^\s*Function : (\S+)", re.M)
ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/")


def _build_tree(csrc: Path, tag: str, sources):
    """One nvcc a source of ``csrc`` into OUT/tag; {source: Popen}."""
    out = OUT / tag
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(out / f"lib{name}.so"), str(csrc / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    return procs


def _ptxas(log: str):
    """{kernel: (registers, spill stores, spill loads)} of a ptxas -v log."""
    info, current = {}, None
    for line in log.splitlines():
        if m := ENTRY.search(line):
            current = m.group(1)
            info.setdefault(current, [0, 0, 0])
        elif m := PROPS.search(line):
            current = m.group(1)
            info.setdefault(current, [0, 0, 0])
        elif (m := SPILL.search(line)) and current:
            info[current][1:] = [int(m.group(1)), int(m.group(2))]
        elif (m := REGS.search(line)) and current:
            info[current][0] = int(m.group(1))
    return info


def _sass(lib: Path):
    """{kernel: its SASS without addresses and encodings}."""
    text = subprocess.run([shutil.which("cuobjdump")
                           or "/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    marks = list(FUNC.finditer(text))
    out = {}
    for i, m in enumerate(marks):
        end = marks[i + 1].start() if i + 1 < len(marks) else len(text)
        body = ADDR.sub("", text[m.end():end])
        out[m.group(1)] = "\n".join(x.strip() for x in body.splitlines()
                                    if x.strip())
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    every = "--all" in argv
    argv = [a for a in argv if a != "--all"]
    if not argv:
        print(__doc__)
        return 2
    other = Path(argv[0]).resolve() / "rten_tpu_torch" / "csrc"
    sources = argv[1:] or list(KV_GROUP)
    here = _build.CSRC
    procs = {("this", n): p for n, p in _build_tree(here, "this",
                                                    sources).items()}
    procs.update({("other", n): p for n, p in _build_tree(other, "other",
                                                          sources).items()})
    logs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        logs[key] = _ptxas(out)
    changed = 0
    for name in sources:
        a = _sass(OUT / "this" / f"lib{name}.so")
        b = _sass(OUT / "other" / f"lib{name}.so")
        ra, rb = logs["this", name], logs["other", name]
        same = sorted(k for k in a.keys() & b.keys() if a[k] == b[k])
        diff = sorted(k for k in a.keys() & b.keys() if a[k] != b[k])
        print(f"{name}: {len(same)} kernels with the same SASS, {len(diff)} "
              f"changed, {len(a.keys() - b.keys())} new, "
              f"{len(b.keys() - a.keys())} gone")
        for k in diff:
            print(f"  changed {k}: this {ra.get(k)} other {rb.get(k)} "
                  f"(registers, spill stores, spill loads)")
        if diff:
            lines = [x for x in difflib.unified_diff(
                b[diff[0]].splitlines(), a[diff[0]].splitlines(),
                "other", "this", n=1, lineterm="")][:24]
            print("  first difference, " + diff[0] + ":\n    "
                  + "\n    ".join(lines))
        for k in sorted(a.keys() - b.keys()):
            print(f"  new {k}: {ra.get(k)}")
        for k in sorted(b.keys() - a.keys()):
            print(f"  gone {k}: {rb.get(k)}")
        changed += len(diff)
        if every:
            for k in sorted(a):
                print(f"  this {k}: {ra.get(k)}")
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main())
