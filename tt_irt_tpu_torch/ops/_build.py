"""Build and load the port's CUDA kernels (plain C entry points, ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/kernels/`` at the root of the checkout (a
git-ignored directory), named by a hash of the source and of the shared
headers ``csrc/*.cuh`` so an edited kernel or header is rebuilt.  Nothing is built at import time: the first launch
on a CUDA tensor builds its library, and ``build_all`` builds several
sources at once (one ``nvcc`` process each, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ["build_all", "load_library", "library_path", "ptxas_registers",
           "sass_tensor_ops", "sources", "BUILD_DIR", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
# No --use_fast_math and no -ftz=true: subnormal density ratios must
# survive into the f64 log-density epilogue.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA kernels need the "
                           "CUDA toolkit on PATH or under /usr/local/cuda")
    return path


def _nvcc() -> str:
    return _tool("nvcc")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    sha = hashlib.sha256()
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            sha.update(fh.read())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}_{sha.hexdigest()[:16]}.so")


def sources() -> list:
    """The names of the kernel sources, ``csrc/<name>.cu``, one library
    each."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all(names) -> dict:
    """Compile every named source not yet built, all in parallel.
    Returns {name: (compiler report (ptxas register/spill lines), seconds
    from the start of the builds to the end of this one)}; raises if any
    build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        src, lib = _target(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)

    def finish(proc):
        out, _ = proc.communicate()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(len(procs), 1)) as pool:
        done = {name: pool.submit(finish, proc)
                for name, (proc, _, _) in procs.items()}
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, secs = done[name].result()
        reports[name] = (out, secs)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library_path(name: str) -> str:
    """The shared library built from ``csrc/<name>.cu``, built on first
    use."""
    _, lib = _target(name)
    if not os.path.exists(lib):
        build_all([name])
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(library_path(name))
    return _LIBS[name]


def ptxas_registers(report: str) -> dict:
    """{kernel (mangled name): (registers, spill-store bytes)} from the
    ptxas lines of a ``build_all`` report (``-Xptxas -v``)."""
    out, name, spill = {}, None, 0
    for ln in report.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", ln)
        if hit:
            name, spill = hit.group(1), 0
            continue
        hit = re.search(r"(\d+) bytes spill stores", ln)
        if hit:
            spill = int(hit.group(1))
        hit = re.search(r"Used (\d+) registers", ln)
        if hit and name is not None:
            out[name] = (int(hit.group(1)), spill)
            name = None
    return out


# A kernel template instance in cuobjdump's function headers (mangled):
# its name, then the rank tier, the 'rt' flag and, for the tensor-core
# kernels, the conditional's variant (ttirt::Tc: 0 wgmma, 1 mma.sync).
_MANGLED = re.compile(r"\d+([a-z][a-z_]*_kernel)ILi(\d+)E"
                      r"(?:Lb(\d)E)?(?:LN5ttirt2TcE(\d)E)?E")
# A kernel of the wide tiers (csrc/factor_wide.cu): the 'rt' flag and the
# prefix update's class, where it has them, and its k-steps.
_MANGLED_WIDE = re.compile(r"\d+([a-z][a-z_]*_wide_kernel)I(?:Lb(\d)E)?"
                           r"(?:NS_\d+([A-Za-z]+?)E)?Li(\d+)EE")


def sass_tensor_ops(name: str) -> dict:
    """Tensor-core instructions in the SASS of ``csrc/<name>.cu``'s
    library, by kernel instance: {"dim_step_kernel<24, irt, wgmma>":
    {"HGMMA": count, "HMMA": count}, ...}; the wide tier's instances as
    "dim_wide_kernel<irt, CoreUpdate, ks16>" (``cuobjdump -sass``; the
    machine needs the CUDA toolkit)."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", library_path(name)],
                         capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in out.split("Function : ")[1:]:
        mangled = part.split(None, 1)[0]
        hit = _MANGLED.search(mangled)
        if hit is None:
            hit = _MANGLED_WIDE.search(mangled)
            if hit is None:
                continue
            kern, rt, update, ksteps = hit.groups()
            tier, variant = None, None
        else:
            kern, tier, rt, variant = hit.groups()
            update = ksteps = None
        label = [] if tier is None else [tier]
        if rt is not None:
            label.append("rt" if rt == "1" else "irt")
        if variant is not None:
            label.append("wgmma" if variant == "0" else "mma")
        if update is not None:
            label.append(update)
        if ksteps is not None:
            label.append(f"ks{ksteps}")
        counts[f"{kern}<{', '.join(label)}>"] = {
            op: len(re.findall(rf"\b{op}\b", part)) for op in ("HGMMA", "HMMA")}
    return counts
