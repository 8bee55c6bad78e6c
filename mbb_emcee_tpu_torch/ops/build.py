"""Build the hand-written CUDA kernels (csrc/*.cu) and bind them with ctypes.

`build_kernels()` compiles every source of csrc/ with nvcc for Hopper
(sm_90a), one nvcc process per source, all started together, and links the
objects into one shared library with a plain C interface, at first use,
into build/mbb_emcee_tpu_torch/<hash>/ beside the package (the hash covers
the sources and the flags, so an edited kernel is rebuilt), and loads it
with ctypes. The compiler's register and spill report is kept beside the
library in build.log (`ptxas_report` reads it per kernel instantiation).
Nothing is compiled when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parent.parent.parent / "build"
              / "mbb_emcee_tpu_torch")
LIB_NAME = "libmbb_kernels.so"
# -fmad=false: no multiply-add contraction, so the kernels round op by op
# as the plain torch versions do (see csrc/lnprob.cuh).
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int


def find_nvcc():
    """Path of nvcc: on PATH, under $CUDA_HOME, or the toolkit's default
    location; None when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    return None


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path():
    """Where the library for the current sources is (or will be) built."""
    return BUILD_ROOT / _source_hash() / LIB_NAME


@functools.lru_cache(maxsize=1)
def build_kernels():
    """Compile (if needed) and load the kernel library; returns the ctypes
    handle, cached for the process after the first success. Raises
    RuntimeError when nvcc is missing or the build fails."""
    lib = library_path()
    if not lib.is_file():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found: the CUDA kernels of mbb_emcee_tpu_torch "
                "are built from csrc/ at first use and need the CUDA "
                "toolkit (nvcc on PATH, or CUDA_HOME set)")
        lib.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            # nvcc tells an object from a source by the .o suffix
            obj = lib.with_name(f"{src.stem}.{tag}.o")
            jobs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for obj, proc in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{obj.name}: code {proc.returncode}\n{out}")
        tmp = lib.with_name(f"{LIB_NAME}.{tag}")
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *(str(obj) for obj, _ in jobs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            if link.returncode != 0:
                failed.append(f"link: code {link.returncode}\n{link.stdout}")
        for obj, _ in jobs:
            obj.unlink(missing_ok=True)
        (lib.parent / "build.log").write_text("".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-6000:])
        os.replace(tmp, lib)
    return _load(str(lib))


def _load(path):
    lib = ctypes.CDLL(path)
    lib.mbb_lnprob_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P,
                                      _P]
    lib.mbb_lnprob_launch.restype = _I
    lib.mbb_stretch_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, ctypes.c_uint64, ctypes.c_uint64, _P, _P, _P]
    lib.mbb_stretch_launch.restype = _I
    lib.mbb_multi_stretch_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _I, _I, ctypes.c_float, ctypes.c_uint64, ctypes.c_uint64, _I, _P,
        _P, _P]
    lib.mbb_multi_stretch_launch.restype = _I
    lib.mbb_multi_resident.argtypes = [_I] * 7
    lib.mbb_multi_resident.restype = _I
    lib.mbb_smem_optin.argtypes = [_I]
    lib.mbb_smem_optin.restype = _I
    lib.mbb_lnprob_smem_bytes.argtypes = [_I, _I, _I]
    lib.mbb_lnprob_smem_bytes.restype = ctypes.c_longlong
    lib.mbb_run_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.mbb_run_smem_bytes.restype = ctypes.c_longlong
    return lib


def build_log():
    """The compiler output of the current build (registers, spills), or
    None before the first build."""
    log = library_path().parent / "build.log"
    return log.read_text() if log.is_file() else None


# A kernel's entry name as nvcc mangles it, with its template arguments
# (lanes per walker, and for the stretch-move kernels cluster):
# mbb_stretch_kernel<8, true> is _Z18mbb_stretch_kernelILi8ELb1EEv...,
# mbb_lnprob_kernel<8> is _Z17mbb_lnprob_kernelILi8EEv...
_ENTRY = re.compile(
    r"_Z\d+(mbb_\w*?_kernel)(?:ILi(\d+)E(?:Lb([01])E)?Ev)?")


def ptxas_report(log):
    """Registers and spill bytes of every kernel entry in nvcc's -Xptxas -v
    output `log`: a list of {"kernel", "group", "cluster", "registers",
    "spill_stores", "spill_loads"} (group and cluster None for an entry
    that is not a template of them; the lnprob kernel has a group and no
    cluster)."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            e = _ENTRY.match(m.group(1))
            if e is None:
                cur = None
            elif cur is None or cur["mangled"] != m.group(1):
                cur = {"mangled": m.group(1), "kernel": e.group(1),
                       "group": None if e.group(2) is None
                       else int(e.group(2)),
                       "cluster": None if e.group(3) is None
                       else e.group(3) == "1",
                       "registers": None, "spill_stores": None,
                       "spill_loads": None}
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return [{k: v for k, v in r.items() if k != "mangled"} for r in rows]
