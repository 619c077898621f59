#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's CUDA sources in two
checkouts.

    python3 scripts/sass_diff.py OTHER [NAME ...]

Builds csrc/<NAME>.cu of this checkout and of the checkout at OTHER into
cubins with the flags of ops/kernels.py build_library (sm_90a; one nvcc
for each, all started together), disassembles each with cuobjdump -sass
and compares them kernel by kernel. For each source it prints the
kernels that only one side has and, for the kernels both have, their
instruction counts and the instructions that differ (difflib over the
instruction text, addresses stripped; the anonymous namespace's name,
which nvcc derives from the file's path, is made the same on both
sides). Without NAMEs, every csrc/*.cu of either checkout. Needs nvcc
and cuobjdump, not a GPU.

Exits 2 without nvcc, 1 if a build fails.
"""

import argparse
import difflib
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# the name of a file's anonymous namespace, with its length:
# 46_GLOBAL__N__bd3cb80f_13_fused_conv_cu_09626567 (8 characters after
# the file's name, not always hex)
ANON = r"\d*_GLOBAL__N__[0-9a-f]{{8}}_\d+_{}_cu_.{{8}}"
ADDR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*")


def disassemble(nvcc: str, flags, src: Path, out: Path) -> dict:
    """{kernel: [instruction, ...]} of src built into out (a cubin)."""
    anon = re.compile(ANON.format(re.escape(src.stem)))
    proc = subprocess.run([nvcc, *flags, "-cubin", "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         str(out)], capture_output=True, text=True, check=True).stdout
    kernels, body = {}, None
    for line in sass.splitlines():
        line = anon.sub("_GLOBAL__N_", line)
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            body = kernels.setdefault(head.group(1), [])
        elif body is not None and ADDR.match(line):
            body.append(ADDR.sub("", line).strip())
    return kernels


def differing(a, b) -> int:
    """Instructions of the longer side in the blocks that differ."""
    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    return sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops
               if tag != "equal")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("names", nargs="*", help="sources (csrc/<name>.cu)")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    try:
        nvcc = K._nvcc()
    except RuntimeError as e:
        print(f"sass_diff: {e}", file=sys.stderr)
        return 2
    # build_library's flags, less those of a shared library
    flags = [f for f in K.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                   "-fPIC")]
    trees = {"this": REPO, "other": Path(args.other).resolve()}
    names = args.names or sorted(
        {p.stem for t in trees.values()
         for p in (t / "tensorflow_ocr_tpu_torch" / "csrc").glob("*.cu")})
    out = K.BUILD_DIR / "sass"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    with ThreadPoolExecutor(max_workers=2 * len(names)) as pool:
        for side, root in trees.items():
            for name in names:
                src = root / "tensorflow_ocr_tpu_torch" / "csrc" / f"{name}.cu"
                if src.exists():
                    jobs[side, name] = pool.submit(
                        disassemble, nvcc, flags, src,
                        out / f"{name}_{side}.cubin")
    try:
        got = {key: job.result() for key, job in jobs.items()}
    except RuntimeError as e:
        print(f"sass_diff: {e}", file=sys.stderr)
        return 1
    for name in names:
        mine, theirs = got.get(("this", name)), got.get(("other", name))
        if mine is None or theirs is None:
            print(f"sass {name}: only in "
                  f"{'this checkout' if theirs is None else args.other}")
            continue
        both = sorted(set(mine) & set(theirs))
        diffs = {k: differing(theirs[k], mine[k]) for k in both}
        print(f"sass {name}: this {len(mine)} kernels, "
              f"{sum(map(len, mine.values()))} instructions; other "
              f"{len(theirs)} kernels, {sum(map(len, theirs.values()))} "
              f"instructions; kernels only here {len(set(mine) - set(theirs))}"
              f", only there {len(set(theirs) - set(mine))}; kernels that "
              f"differ {sum(1 for d in diffs.values() if d)} of {len(both)}, "
              f"differing instructions {sum(diffs.values())}")
        for k in sorted(set(mine) ^ set(theirs)):
            print(f"  only {'here' if k in mine else 'there'}: {k}")
        for k in both:
            if diffs[k]:
                print(f"  differs: {k}: this {len(mine[k])}, other "
                      f"{len(theirs[k])} instructions, {diffs[k]} differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
