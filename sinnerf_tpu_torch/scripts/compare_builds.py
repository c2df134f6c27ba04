"""Whether two checkouts compile a CUDA source of the port to the same
kernels: per kernel, the registers, stack and spills that ``-Xptxas -v``
reports and the count of every SASS opcode.

    python -m sinnerf_tpu_torch.scripts.compare_builds OTHER_ROOT SOURCE [SOURCE ...]

builds each ``csrc/<SOURCE>`` in this checkout and in ``OTHER_ROOT`` (each
with that checkout's own ``ops/_build.py``, into its own ``build/kernels``),
pairs the kernels by their demangled names up to the argument list, and a
kernel left alone on each side under one name before its template arguments
and namespaces (one made a template, or moved into a namespace, between the
two) with the other, prints one JSON line
per pair, and exits 1 if a pair differs or a kernel has no partner.  Needs
``nvcc``, ``cuobjdump`` and ``cu++filt``: it runs on the card's machine.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict

from sinnerf_tpu_torch.ops import _build


def _build_module(root: Path):
    """The ``ops/_build.py`` of the checkout at ``root`` (standard library only)."""
    spec = importlib.util.spec_from_file_location(f"_build_{abs(hash(root))}", root / "sinnerf_tpu_torch/ops/_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _name(demangled: str) -> str:
    """``void ns::f<(T)1>(float const*, ...)`` -> ``ns::f<(T)1>``: the
    demangled name without its last parenthesised group, the arguments."""
    depth = 0
    for i in range(len(demangled) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(demangled[i], 0)
        if demangled[i] == "(" and depth == 0:
            demangled = demangled[:i]
            break
    return demangled.replace("void ", "", 1)


def _demangle(names) -> Dict[str, str]:
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cu++filt")
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, check=True).stdout
    return {m: _name(d) for m, d in zip(names, out.splitlines())}


def pairs(mine, theirs):
    """(name, other name) of every kernel in ``mine`` or ``theirs``, None for
    one without a partner."""
    out = [(n, n) for n in sorted(set(mine) & set(theirs))]
    alone = {side: {n for n in names if n not in mine or n not in theirs}
             for side, names in (("a", mine), ("b", theirs))}
    def base(n):  # the name before its template arguments, without its namespaces
        return n.split("<")[0].split("::")[-1]

    for n in sorted(alone["a"]):
        a = [m for m in alone["a"] if base(m) == base(n)]
        b = [m for m in alone["b"] if base(m) == base(n)]
        if len(a) == 1 and len(b) == 1:
            out.append((n, b[0]))
            alone["b"].discard(b[0])
        else:
            out.append((n, None))
    return out + [(None, n) for n in sorted(alone["b"])]


def kernels(build_module, source: str) -> Dict[str, dict]:
    """Per kernel of ``source`` as ``build_module`` builds it: its usage and
    opcode counts, keyed by the demangled name without arguments."""
    build_module.build([source])
    lib = build_module.lib_path(source)
    usage = _build.ptxas_usage(lib.with_suffix(".log"))
    sass = _build.sass_opcodes(lib)
    names = _demangle(sorted(sass))
    return {names[m]: dict(usage=usage.get(m, {}), sass=dict(sorted(sass[m].items()))) for m in sass}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", type=Path)
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args(argv)
    other = _build_module(args.other_root.resolve())
    differ = False
    for source in args.sources:
        mine, theirs = kernels(_build, source), kernels(other, source)
        for name, partner in pairs(mine, theirs):
            a, b = mine.get(name), theirs.get(partner)
            same = a is not None and a == b
            differ |= not same
            print(json.dumps(dict(source=source, kernel=name, other=partner, same=same,
                                  usage=a and a["usage"], other_usage=b and b["usage"],
                                  sass_total=a and sum(a["sass"].values()),
                                  other_sass_total=b and sum(b["sass"].values()))))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
