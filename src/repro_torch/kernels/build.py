"""Build the CUDA kernels with ``nvcc`` into one shared library, loaded by ctypes.

The sources in ``src/repro_torch/csrc/`` have a plain C interface and do not
include PyTorch's headers, so each compiles in seconds.  One ``nvcc`` per
source runs in parallel; the objects are then linked into one library under
``build/`` at the root of the checkout, named by a hash of the sources and
flags, so an unchanged library is reused and a changed one is rebuilt.  The
build happens at the first launch, never at import.  A measurement build,
``load_library(defines)``, compiles the same sources with extra ``-D``
defines into a library of its own beside it (``chip_smoke.py`` times the
nmi kernel's stages so, ``launch/profile_forward.py`` the forward kernels').
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["BuildInfo", "Library", "load_library", "nvcc_path", "sass_counts"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("bsi_ttli.cu", "bsi_separable.cu", "bsi_tt.cu", "bsi_matmul.cu",
           "bsi_adjoint.cu", "bsi_fused.cu", "flash_attention.cu",
           "flash_attention_sm90.cu")
HEADERS = ("bsi_common.cuh", "bsi_forward.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)  # fmt: skip
# The fused kernels round every multiply and add of the displacement and the
# warp as the plain version does (no contraction into FMAs), so their warped
# samples, and the stats kernel's min and max, equal the plain version's bit
# for bit.
# The TT kernel likewise equals the plain ``bsi_tt`` bit for bit.
# The float32 flash kernel at ptxas -O1: at -O3 its scheduler hoists loads
# past the 255 registers and spills accumulator values (80 bytes at head dim
# 256), 5% faster on the card but not spill-free (PERF.md, section 6).
SOURCE_FLAGS = {"bsi_fused.cu": ("-fmad=false",), "bsi_tt.cu": ("-fmad=false",),
                "flash_attention.cu": ("-Xptxas", "-O1")}

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
_DIMS = "i" * 13  # nx, ny, nz, dx, dy, dz, X, Y, Z, bx, by, bz, form
# C signature of each entry point, one letter per argument (p: pointer, i:
# int, f: float); each ends with the stream (the layout query with its
# output) and returns a cudaError_t.
_SIGNATURES = {
    "bsi_ttli_f32": "ppp" + "i" * 11,  # ..., X, Y, Z, bz
    "bsi_separable_f32": "ppp" + "i" * 11,
    "bsi_tt_f32": "ppp" + "i" * 11,  # ..., X, Y, Z, columns a block
    "bsi_matmul_f32": "ppp" + "i" * 12,  # ..., X, Y, Z, z tiles a unit, blocks
    "bsi_adjoint_f32": "p" * 6 + "i" * 14,
    "bsi_adjoint_matmul_f32": "pppp" + "i" * 14,
    "bsi_fused_ssd_f32": "ppppp" + "ip" + _DIMS,
    "bsi_fused_stats_f32": "pppp" + "ip" + _DIMS,
    "bsi_fused_ncc_f32": "pppppp" + "ip" + _DIMS,
    "bsi_fused_nmi_f32": "ppppppp" + "ip" + _DIMS + "iiff",
    "bsi_fused_lncc_f32": "ppppp" + "ip" + _DIMS + "iiii" + "ff",
    "bsi_fused_walk_layout": _DIMS,  # ..., form; out: chunk, smem (2 long long)
    # q, k, v, out; B, S, H, KV, hd, causal, window; scale, softcap
    "flash_attention_f32": "pppp" + "i" * 7 + "ff",  # flash_attention.cu
    "flash_attention_bf16": "pppp" + "i" * 7 + "ff",  # flash_attention_sm90.cu
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    # one "kernel: N registers, M bytes spill" line per kernel, and ptxas's
    # "Potential Performance Loss" notes (a wgmma serialised) as they stand;
    # kept beside the library, so a build reused from disk has them too
    ptxas: tuple


class Library:
    """The loaded kernels: call ``lib.<entry point>(...)``; ``info`` is the build."""

    def __init__(self, info: BuildInfo):
        self.info = info
        self._dll = ctypes.CDLL(str(info.path))
        for name, sig in _SIGNATURES.items():
            fn = getattr(self._dll, name)
            fn.argtypes = [_CTYPES[c] for c in sig + "p"]
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "are built from source at first use"
    )


def _digest(defines) -> str:
    h = hashlib.sha256(" ".join(FLAGS + defines).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _ptxas_summary(log: str) -> tuple:
    """One line per kernel from ``-Xptxas -v``: registers, spills, smem; and
    each "Potential Performance Loss" note."""
    lines, kernel, spills = [], None, "spills not reported"
    for line in log.splitlines():
        if "Performance Loss" in line:
            lines.append(line.strip())
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            spills = f"{m.group(1)}/{m.group(2)} B spill stores/loads"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(
                f"{kernel}: {m.group(1)} registers, {spills}, "
                f"{smem.group(1) if smem else 0} B static smem"
            )
            kernel = None
    return tuple(lines)


def _build(out: Path, defines=()) -> BuildInfo:
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in SOURCES:  # one nvcc per source, all started together
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *FLAGS, *SOURCE_FLAGS.get(name, ()),
                   *(f"-D{d}" for d in defines), "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, _, p in procs:
            text, _ = p.communicate()
            log.append(text)
            if p.returncode:
                failed.append(f"{name}:\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = [nvcc, "-shared", *(str(o) for _, o, _ in procs), "-o", str(tmp_lib)]
        subprocess.run(link, check=True, capture_output=True, text=True)
        ptxas = _ptxas_summary("\n".join(log))
        _ptxas_file(out).write_text("\n".join(ptxas))  # before the library: see load_library
        os.replace(tmp_lib, out)
    return BuildInfo(out, time.perf_counter() - t0, ptxas)


def _ptxas_file(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def sass_counts(path, function_part, opcode) -> dict:
    """``{function: n}``: the SASS instructions whose opcode starts with
    ``opcode`` (``HGMMA``: wgmma) in each function of the library at ``path``
    whose mangled name holds ``function_part``, by ``cuobjdump -sass``."""
    cuobjdump = str(Path(nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if function_part in m.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?" + opcode, line):
            counts[fn] += 1
    return counts


@functools.lru_cache(maxsize=None)
def load_library(defines=()) -> Library:
    """Build the kernels if needed and load them (once per process).
    ``defines`` (``"NAME=VALUE"``, passed to every ``nvcc`` as ``-D``) give a
    measurement build, a library of its own."""
    defines = tuple(defines)
    out = BUILD_ROOT / f"librepro_torch_kernels-{_digest(defines)}.so"
    if out.exists():  # built earlier: its ptxas summary was kept beside it
        info = BuildInfo(out, 0.0, tuple(_ptxas_file(out).read_text().splitlines()))
    else:
        info = _build(out, defines)
    return Library(info)
