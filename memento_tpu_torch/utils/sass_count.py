"""Static instruction counts of the CUDA kernels, by pipe.

    python -m memento_tpu_torch.utils.sass_count [--listing DIR] [LIB.so ...]

With no library named it builds ``csrc/*.cu`` (needs ``nvcc``, no card) and
counts those.  For each kernel of each library it prints one JSON line: the
SASS instructions of ``cuobjdump -sass`` by the pipe that issues them, for the
whole kernel and for the bodies of its five largest loops (a branch to a
lower address).  ``--listing`` also writes the listings there, to read the
regions off.  The counts are static: how often a loop runs is not in them.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

from .. import build

PIPES = (
    ("fp32", r"^(FADD|FMUL|FFMA|FMNMX|FSEL|FSET|FSETP|FCHK)"),
    ("imad", r"^IMAD"),
    ("integer", r"^(IADD3|LOP3|SHF|LEA|ISETP|SEL|IMNMX|PRMT|IABS|FLO|POPC|"
                r"VIADD|VIMNMX|PLOP3|P2R|R2P|MOV|CS2R|S2R)"),
    ("special", r"^MUFU"),
    ("convert", r"^(I2F|F2I|FRND|F2F|I2FP|F2FP)"),
    ("shared", r"^(LDS|STS|LDSM)"),
    ("global", r"^(LDG|STG|LD\b|ST\b|LDL|STL|ATOM|RED)"),
    ("constant", r"^(LDC|ULDC)"),
    ("uniform", r"^(U[A-Z0-9]+|R2UR|VOTEU)"),
    ("control", r"^(BRA|BSSY|BSYNC|EXIT|BAR|WARPSYNC|CALL|RET|NOP|BREAK|"
                r"SHFL|VOTE|YIELD|DEPBAR|ERRBAR|MEMBAR|BMOV|NANOSLEEP)"),
)


def pipe_of(op: str) -> str:
    return next((p for p, rx in PIPES if re.match(rx, op)),
                "other:" + op.split(".")[0])


def by_pipe(ops) -> dict:
    return dict(collections.Counter(pipe_of(op) for op in ops).most_common())


def count_listing(listing: str) -> list:
    """One row per kernel of a ``cuobjdump -sass`` listing: ``{"kernel",
    "count", "by_pipe", "loops": [{"from", "to", "count", "by_pipe"}]}``,
    the loops largest first, five at most."""
    rows = []
    for name, body in re.findall(r"Function : (\S+)(.*?)(?=Function :|\Z)",
                                 listing, flags=re.S):
        code = [(int(addr, 16), op, rest) for addr, op, rest in re.findall(
            r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)([^;]*);",
            body)]
        loops = []
        for addr, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)\s*$", rest)
            if op.startswith("BRA") and target \
                    and int(target.group(1), 16) <= addr:
                start = int(target.group(1), 16)
                inside = [o for a, o, _ in code if start <= a <= addr]
                loops.append({"from": hex(start), "to": hex(addr),
                              "count": len(inside),
                              "by_pipe": by_pipe(inside)})
        rows.append({"kernel": name, "count": len(code),
                     "by_pipe": by_pipe(op for _, op, _ in code),
                     "loops": sorted(loops, key=lambda x: -x["count"])[:5]})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("libraries", nargs="*", type=Path)
    parser.add_argument("--listing", type=Path, default=None)
    args = parser.parse_args()
    kernels = [name for name, lib in build.LIBRARIES.items()
               if lib.compiler == "nvcc"]
    libraries = args.libraries or list(build.build(kernels).values())
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    for lib in libraries:
        proc = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"{lib}: cuobjdump exit {proc.returncode}\n{proc.stderr}",
                  file=sys.stderr)
            return 1
        if args.listing is not None:
            args.listing.mkdir(parents=True, exist_ok=True)
            (args.listing / f"{lib.stem}.sass").write_text(proc.stdout)
        for row in count_listing(proc.stdout):
            print(json.dumps({"library": lib.name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
