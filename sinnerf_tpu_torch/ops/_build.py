"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/kernels/<name>-<hash>.so`` at the root of the checkout.
The hash covers the source, every ``csrc/*.cuh`` header and the flags, so an
edited source is rebuilt at its next use.  Sources that need building are
compiled in parallel, one ``nvcc`` each.  ``--use_fast_math`` stays off: it
would change ``expf``/``sinf``/``cosf`` (and so the positional encoding) and
could fold the compositing's ``+1e-10`` guard.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_render.cu", "fused_render_sm90.cu", "fused_sample_pdf.cu", "fused_render_train.cu",
           "fused_render_train_sm90.cu", "f32_train_sm90.cu", "fused_mlp.cu", "fused_mlp_sm90.cu",
           "exp_kernel_variants.cu", "exp_bwd_pipeline.cu", "exp_kernel_variants_sm90.cu", "exp_bwd_pipeline_sm90.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # optimise a source's kernels on all cores: on an 8-core H100 host the
    # six sources built together in 39 s instead of 78 s (exp_bwd_pipeline.cu's
    # nine kernels alone: 32 s instead of 87 s)
    "--split-compile=0",
    "-Xptxas=-v",  # registers, shared memory and spills go to the .log
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def build(sources: Iterable[str] = SOURCES) -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in sources:
        out = lib_path(source)
        if out.exists():
            continue
        tmp = out.parent / f"{out.stem}.tmp{os.getpid()}.so"
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        jobs.append((source, out, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for source, out, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{source}:\n{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    with _lock:
        if source not in _libs:
            build([source])
            _libs[source] = ctypes.CDLL(str(lib_path(source)))
        return _libs[source]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptxas_usage(log: Path) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of a build's .log, what ``-Xptxas -v`` said:
    registers, stack frame, spill stores and spill loads (bytes)."""
    usage: Dict[str, Dict[str, int]] = {}
    name = None
    for line in Path(log).read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
        elif name and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            usage[name].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif name and "registers" in line:
            usage[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return usage


def sass_opcodes(lib: Path) -> Dict[str, Counter]:
    """Per kernel (mangled name) of a built library, how often each SASS
    opcode (with its modifiers) occurs, from ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300, check=True).stdout
    counts: Dict[str, Counter] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = Counter()
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            words = line.split("*/", 1)[1].split(";")[0].split()
            words = [w for w in words if not w.startswith("@")]
            if words:
                counts[name][words[0]] += 1
    return counts
