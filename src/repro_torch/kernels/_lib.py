"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded through
``ctypes``. The sources compile in parallel, one ``nvcc -c`` process each,
all started together, and one ``nvcc -shared`` call links the library: the
build takes as long as its slowest source, not their sum. The build runs at
first use and again whenever a source (or the flag set) changes: the
library's file name carries a hash of both. Nothing here runs at import
time, so the package imports on machines without a GPU or a CUDA toolkit.

No fast-math flags: ``--use_fast_math`` implies ``-ftz=true``, and flushing
subnormals would change ``absmax`` and with it the stored checkpoint bytes.

Launch counts: each kernel wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {"fingerprint": 0, "absmax": 0, "quantize": 0,
                            "dequantize": 0, "flash_attention_fwd": 0,
                            "flash_attention_dkv": 0, "flash_attention_dq": 0,
                            "decode_attention": 0, "ssm_scan": 0,
                            "rglru_scan": 0,
                            # the two variants of the forward and the dkv
                            # pass (each launch counts under its pass too):
                            # bfloat16 on the tensor cores, float32 on the
                            # CUDA cores
                            "flash_attention_fwd_wgmma": 0,
                            "flash_attention_fwd_cudacore": 0,
                            "flash_attention_dkv_wgmma": 0,
                            "flash_attention_dkv_cudacore": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
_SIGNATURES = {
    # (x, nbytes, itemsize, block_bytes, n_blocks, out, old|NULL, diff|NULL, stream)
    "spot_fingerprint": (_P, _I64, _I32, _I64, _I64, _P, _P, _P, _P),
    # (x, n, dtype_code, partial, n_partial, out, stream)
    "spot_absmax": (_P, _I64, _I32, _P, _I32, _P, _P),
    # (x, n, dtype_code, inv, q, stream)
    "spot_quantize": (_P, _I64, _I32, _F32, _P, _P),
    # (q, n, scale, dtype_code, out, stream)
    "spot_dequantize": (_P, _I64, _F32, _I32, _P, _P),
    # (q, k, v, o, lse, B, Sq, Skv, H, KV, hd, dtype_code, causal, window,
    #  scale, stream)
    "spot_flash_attention_fwd": (_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                                 _I32, _I32, _I32, _I32, _I32, _F32, _P),
    # (q, k, v, do, lse, dsum, dk, dv, B, Sq, Skv, H, KV, hd, dtype_code,
    #  causal, window, scale, stream)
    "spot_flash_attention_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                                 _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                                 _F32, _P),
    # (q, k, v, do, lse, dsum, dq, B, Sq, Skv, H, KV, hd, dtype_code, causal,
    #  window, scale, stream)
    "spot_flash_attention_dq": (_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                                _I32, _I32, _I32, _I32, _I32, _I32, _F32, _P),
    # (hd) -> dynamic shared memory bytes of the bf16 tensor-core kernels
    "spot_flash_attention_fwd_wgmma_smem": (_I32,),
    "spot_flash_attention_dkv_wgmma_smem": (_I32,),
    # (q, k, v, o, B, S, H, KV, hd, valid_len, dtype_code, scale, stream)
    "spot_decode_attention": (_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                              _I32, _I32, _F32, _P),
    # (a, b, h, h_last, B, S, W, dtype_code, stream)
    "spot_rglru_scan": (_P, _P, _P, _P, _I32, _I32, _I32, _I32, _P),
    # (u, dt, A, B, C, D, y, h_last, B, S, DI, N, dtype_code, stream)
    "spot_ssm_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                      _I32, _P),
}

# element-type codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
FLOAT_DTYPES = tuple(DTYPE_CODES)            # the checkpoint kernels
# the model kernels' template instances: the dtypes and head dimensions the
# models serve and train in, and no others (phi3-mini trains at head dim 96)
SERVING_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 96, 128, 256)          # flash attention forward and backward
DECODE_HEAD_DIMS = (64, 128, 256)       # flash decode
SSM_STATES = 16                         # the selective scan's d_state


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    objdir = Path(tempfile.mkdtemp(prefix="obj-", dir=target.parent))
    try:
        objs = [objdir / f"{src.stem}.o" for src in _sources()]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for src, obj in zip(_sources(), objs)]
        errors, logs = [], []
        for p in procs:
            _out, err = p.communicate()
            logs.append(err)
            if p.returncode != 0:
                errors.append(err)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        # ptxas -v: each kernel's registers, shared memory and spills
        target.with_suffix(".ptxas.log").write_text("\n".join(logs))
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", *map(str, objs),
                              "-o", str(tmp)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stderr}")
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    # a build cache, not checkpoint data: a library lost to a crash is
    # rebuilt from the sources, so the rename needs no fsync
    os.replace(tmp, target)  # spotlint: ignore[SPOT001,SPOT002]


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, _build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA kernels need a GPU; none is available")
        import time
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"libspot_kernels-{_digest()}.so"
        t0 = time.perf_counter()
        # the build runs under the lock on purpose: every launch needs the
        # library, and SpotTrainer builds it before its first step, so no
        # save path waits here
        with open(BUILD_DIR / "build.lock", "w") as lockf:  # spotlint: ignore[SPOT031]
            fcntl.flock(lockf, fcntl.LOCK_EX)   # one build at a time across processes
            if not target.exists():
                _build(target)
        _build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def build_seconds() -> float | None:
    """Wall time the first ``library()`` call spent building/loading."""
    return _build_seconds


def ptxas_report() -> dict[str, dict[str, int]]:
    """{mangled kernel name: {"registers", "smem", "spill_stores",
    "spill_loads"}} from the ``ptxas -v`` output of the library's build
    ("smem": static shared memory only; the flash kernels' is dynamic)."""
    log = BUILD_DIR / f"libspot_kernels-{_digest()}.ptxas.log"
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in log.read_text().splitlines() if log.exists() else ():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["smem"] = int(m.group(1))
    return out


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, what: str, dtypes=None) -> None:
    """Validate a kernel operand: CUDA, contiguous, one of ``dtypes``,
    4-byte aligned."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{what}: unsupported dtype {t.dtype}")
    if t.data_ptr() % 4:
        raise ValueError(f"{what}: data pointer must be 4-byte aligned")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if any input requires grad: a raw kernel entry point records no
    backward, and no autograd graph may record silently through its plain
    version (the differentiable wrappers call it with grad disabled)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: inputs require grad, but this entry point "
                           "records no backward; call it under "
                           "torch.no_grad() or use its differentiable wrapper")
