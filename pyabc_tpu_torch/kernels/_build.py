"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc -c`` for ``sm_90a``, all started
together, and the objects are linked into one shared library with a plain
C interface that ``ctypes`` loads. Compiling the sources side by side keeps
the build as long as its slowest source rather than their sum, which
matters as later kernels join ``csrc/``. The build runs at first use into
``build/pyabc_tpu_torch/`` beside the package and is keyed by a hash of
the sources and flags, so an unchanged tree reuses its library.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pyabc_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U = ctypes.c_uint

#: C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "pyabc_mvn_mixture_logpdf": [
        _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _F, _P, _P],
    "pyabc_mvn_mixture_logpdf_models": [
        _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "pyabc_lv_simulate": [
        _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _U, _U, _U, _U, _U, _U, _P,
        _P, _P],
    "pyabc_ode_family_simulate": [
        _P, _P, _I, _I, _I, _I, _F, _F, _F, _U, _U, _U, _U, _U, _U, _P, _P,
        _P],
    "pyabc_gaussian_simulate": [_P, _I, _I, _I, _U, _U, _U, _U, _U, _U, _P,
                                _I, _I, _I, _P, _P],
    "pyabc_mean_only_simulate": [_P, _I, _I, _F, _U, _U, _U, _U, _U, _U, _P,
                                 _P, _P],
    "pyabc_sir_simulate": [
        _P, _I, _I, _I, _I, _F, _F, _F, _U, _U, _U, _U, _U, _U, _P, _P, _P],
    "pyabc_pnorm_accept_weight": [
        _P, _I, _I, _P, _P, _F, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _P,
        _P, _P],
    "pyabc_compact_round": [
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "pyabc_compact_shards": [
        _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
        _P, _P, _P, _F, _P, _I, _I, _P, _P, _P],
    "pyabc_shard_mask": [_I, _I, _P, _P, _P, _P, _P, _P],
    "pyabc_mesh_pack": [_I, _P, _P, _P, _P],
    "pyabc_mesh_unpack": [_I, _P, _P, _P, _I, _P],
    "pyabc_temperature_update": [
        _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
        _F, _I, _I, _F, _I, _I, _F, _F, _I, _P, _P, _P],
    "pyabc_kernel_accept": [
        _P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _U, _U, _U, _U,
        _U, _P, _P, _P, _P, _P],
    "pyabc_propose": [
        _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _U, _U, _U,
        _U, _U, _U, _P, _I, _P, _P, _P, _P],
    "pyabc_propose_models": [
        _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P,
        _P, _P, _U, _U, _U, _U, _U, _U, _U, _P, _I, _P, _P, _P, _P, _P],
    "pyabc_philox_blocks": [_P, _I, _U, _U, _P, _P, _P, _P],
    "pyabc_normalize_log_weights": [_P, _P, _I, _P, _P],
    "pyabc_weighted_quantile": [_P, _P, _I, _F, _P, _P, _P],
    "pyabc_mvn_fit": [
        _P, _P, _I, _I, _I, _F, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P],
    "pyabc_mvn_fit_models": [
        _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P],
    "pyabc_chol_guarded": [_P, _I, _P, _P, _P, _P],
    "pyabc_grid_search_cv": [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "pyabc_boot_draw": [
        _P, _I, _I, _I, _U, _U, _U, _U, _U, _I, _I, _P, _P, _P],
    "pyabc_boot_fit": [
        _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P],
    "pyabc_boot_density": [
        _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "pyabc_boot_bisect": [_P, _I, _I, _P, _P, _P, _F, _P],
    "pyabc_boot_local_gather": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "pyabc_boot_local_density": [
        _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "pyabc_model_step": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "pyabc_scale_reduce": [
        _P, _I, _I, _P, _P, _I, _F, _I, _P, _I, _F, _P, _P, _P, _P, _P, _P],
    "pyabc_pack_rows": [_I, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P],
    "pyabc_cast_rows": [_I, _P, _I, _I, _I, _P, _I, _I, _P, _P],
    "pyabc_pack_models": [_I, _P, _I, _P, _I, _I, _P, _P],
    "pyabc_tau_leap": [
        _P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _P, _U, _U, _U, _U, _U, _U,
        _P, _P],
    "pyabc_network_sir": [
        _P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _P, _U, _U, _U, _U, _U, _U,
        _P, _P],
    "pyabc_segment_round": [
        _P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _P, _F, _P, _P, _I, _P, _P,
        _P, _P, _P, _U, _U, _U, _U, _U, _P, _I, _F, _P, _U, _U, _U, _U, _I,
        _P, _P, _I, _P, _P],
    "pyabc_ridge_fit": [
        _P, _P, _P, _I, _I, _I, _P, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P],
    "pyabc_linear_transform": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "pyabc_linear_accept": [
        _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P,
        _F, _P, _P, _P, _P],
    "pyabc_linear_bound": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "pyabc_mlp_fit": [
        _P, _P, _P, _I, _P, _I, _P, _I, _F, _I, _I, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "pyabc_mlp_transform": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "pyabc_mlp_accept": [
        _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P,
        _P, _P, _F, _P, _P, _P, _P],
    "pyabc_gp_transform": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                           _P],
    "pyabc_gp_accept": [
        _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _P,
        _P, _P, _P, _P, _F, _P, _P, _P, _P],
    "pyabc_aggregate_accept": [
        _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _P,
        _P, _P, _P, _P, _P],
    "pyabc_aggregate_refit": [
        _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
        _P, _P, _P, _P, _P],
    "pyabc_aggregate_finish_shards": [
        _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "pyabc_ode_family_segments": [
        _P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _P, _U, _U, _U, _U,
        _U, _U, _P, _P],
    "pyabc_moment_fold": [
        _P, _P, _I, _I, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P, _P],
    "pyabc_moment_fold_shards": [
        _P, _P, _I, _I, _I, _P, _P, _P, _P, ctypes.c_longlong, _I, _P],
    "pyabc_moment_finish_shards": [
        _P, _I, _I, _P, _I, _F, _I, _P, _I, _F, _P, _P, _P, _P, _P],
    "pyabc_moment_finish": [
        _P, _I, _P, _I, _F, _I, _P, _I, _F, _P, _P, _P, _P],
    "pyabc_local_cov": [
        _P, _P, _I, _I, _I, _P, _I, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _I, _P],
    "pyabc_local_factor": [
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P],
    "pyabc_local_logpdf": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P],
    "pyabc_local_logpdf_models": [
        _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P],
    "pyabc_proposal_drift": [
        _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _F, _P, _P, _P,
        _P, _P, _P],
    "pyabc_proposal_drift_models": [
        _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _F, _P,
        _P, _P, _P, _P, _P, _P],
    "pyabc_generation_health": [
        _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _I,
        _P, _P, _P, _P, _P, _P, _F, _F, _I, _F, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
#: the error of a failed build, raised again instead of building anew
_build_error: RuntimeError | None = None
#: seconds the last build took (0.0 when a cached library was loaded)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of pyabc_tpu_torch are built at "
        "first use on a machine with the CUDA toolkit (set CUDA_HOME)"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    nvcc = _nvcc()
    objdir = out.parent / f"obj-{out.stem}-{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = objdir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, _obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for _s, o, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, _build_error, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise _build_error
        out = BUILD_DIR / f"libpyabc_tpu_torch_{_digest()}.so"
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            try:
                _build(out)
            except RuntimeError as exc:
                _build_error = exc
                raise
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
