"""Build the CUDA sources in ``icem_torch/csrc`` with nvcc and load them.

The kernels have a plain C interface and are loaded with ``ctypes``: no
PyTorch headers are compiled, so a build takes seconds. The library is built
at first use into ``build/icem_torch/<hash>/`` at the root of the checkout,
keyed by a hash of the sources and the flags, and reused while neither
changes. Each ``.cu`` file is compiled by its own nvcc process, all started
together, then linked. Outputs are written under temporary names and renamed
into place, so processes that build at the same time do not collide.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "icem_torch"
# every warning is an error: nvcc compiles a device call to a host-only
# function with a warning and then drops the code that depends on it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Werror", "all-warnings", "-Xptxas", "-v")
LIB_NAME = "libicem_torch_kernels.so"


@dataclass(frozen=True)
class BuildInfo:
    path: Path          # the shared library
    seconds: float      # time spent compiling in this process (0 when reused)
    ptxas_log: str      # nvcc's -Xptxas -v report: registers, spills, per kernel


_LOADED: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _content_hash(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of any that fail.
    Returns their combined stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    logs = []
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return "".join(logs)


def build(defines=()) -> BuildInfo:
    """Build the kernels' shared library unless this content is built.
    ``defines`` (``-DNAME=VALUE`` flags) build a variant into its own
    directory; the port itself loads the build without any."""
    flags = (*NVCC_FLAGS, *defines)
    out_dir = BUILD_ROOT / _content_hash(flags)
    lib = out_dir / LIB_NAME
    log_path = out_dir / "ptxas.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f".{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs = [out_dir / (src.stem + tag + ".o") for src in _sources()]
    log = _run_all([[nvcc, *flags, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(_sources(), objs)])
    tmp_lib = out_dir / (LIB_NAME + tag)
    _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], *map(str, objs), "-o", str(tmp_lib)]])
    seconds = time.perf_counter() - t0
    tmp_log = out_dir / ("ptxas.log" + tag)
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
    os.replace(tmp_lib, lib)
    for obj in objs:
        obj.unlink()
    return BuildInfo(lib, seconds, log)


def ptxas_report(log: str, key: str) -> dict:
    """Registers, stack frame and spill bytes of the one kernel entry whose
    mangled name holds ``key``, from nvcc's -Xptxas -v report."""
    found = []
    for block in re.split(r"(?=ptxas info\s*: Compiling entry function)", log):
        name = re.match(r"ptxas info\s*: Compiling entry function '([^']+)'", block)
        if not (name and key in name.group(1)):
            continue
        regs = re.search(r"Used (\d+) registers", block)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", block)
        if not (regs and frame):
            raise RuntimeError(f"incomplete ptxas report for {name.group(1)}")
        found.append(dict(registers=int(regs.group(1)), stack=int(frame.group(1)),
                          spill_stores=int(frame.group(2)), spill_loads=int(frame.group(3))))
    if len(found) != 1:
        raise RuntimeError(f"expected one ptxas report for {key}, found {len(found)}")
    return found[0]


def occupancy(lib, ptxas_log: str, kernel: str, shape) -> dict:
    """The resources of ``<kernel>_rollout_kernel`` at ``shape`` in a build
    (``lib``, a ctypes.CDLL, and its ptxas log): registers, stack and spill
    bytes, and, from the library's ``<kernel>_smem_bytes_<shape>`` and
    ``<kernel>_warps_per_sm_<shape>``, the dynamic shared memory per block
    and the warps an SM holds at once."""
    tag = "_".join(map(str, shape))
    smem_fn = getattr(lib, f"{kernel}_smem_bytes_{tag}")
    warps_fn = getattr(lib, f"{kernel}_warps_per_sm_{tag}")
    smem_fn.restype = warps_fn.restype = ctypes.c_int
    smem_fn.argtypes = warps_fn.argtypes = []
    entry = f"{kernel}_rollout_kernelILi" + "ELi".join(map(str, shape)) + "E"
    return dict(ptxas_report(ptxas_log, entry), shape=", ".join(map(str, shape)),
                smem_per_block=smem_fn(), warps_per_sm=warps_fn())


def load_library():
    """The kernels' library, built on first use and loaded once per process.
    Returns (ctypes.CDLL, BuildInfo)."""
    if "lib" not in _LOADED:
        info = build()
        _LOADED["lib"] = (ctypes.CDLL(str(info.path)), info)
    return _LOADED["lib"]
