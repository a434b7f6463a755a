"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded through
``ctypes``. The sources compile in parallel, one ``nvcc -c`` process each,
all started together, and one ``nvcc -shared`` call links the library: the
build takes as long as its slowest source, not their sum. The build runs at
first use and again whenever a source (or the flag set) changes: the
library's file name carries a hash of both. Nothing here runs at import
time, so the package imports on machines without a GPU or a CUDA toolkit.

The library lives in ``<repo>/build/repro_torch_kernels`` unless
``set_build_dir`` moves it before the first ``library()`` call (the
training entry point puts it on the checkpoint volume, so a replacement
instance loads it instead of building it). Each load refreshes the
library's mtime: to a sweep of that directory "old" means unused.

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
import math
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

LAUNCHES: dict[str, int] = {# an urgent save's chunk addresses and CRCs
                            "chunk_digest": 0, "fingerprint": 0,
                            # the fingerprint's second launch: each
                            # block's slice sums to its digest and diff
                            "fingerprint_final": 0, "absmax": 0, "quantize": 0,
                            "dequantize": 0, "flash_attention_fwd": 0,
                            "flash_attention_dkv": 0, "flash_attention_dq": 0,
                            "decode_attention": 0,
                            # flash decode's second launch: the merge of
                            # the split pass's partials
                            "decode_attention_merge": 0, "ssm_scan": 0,
                            # the scan's two instances (each launch counts
                            # under ssm_scan too)
                            "ssm_scan_bf16": 0, "ssm_scan_f32": 0,
                            "rglru_scan": 0,
                            # the two variants of the forward, the dkv and
                            # the dq pass (each launch counts under its pass
                            # too), both on the tensor cores: bfloat16
                            # through wgmma, float32 in 3xTF32 (mma.sync)
                            "flash_attention_fwd_wgmma": 0,
                            "flash_attention_fwd_tf32x3": 0,
                            "flash_attention_dkv_wgmma": 0,
                            "flash_attention_dkv_tf32x3": 0,
                            "flash_attention_dq_wgmma": 0,
                            "flash_attention_dq_tf32x3": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_dir: Path = BUILD_DIR
_build_seconds: float | None = None
_built: bool | None = None         # whether this process ran nvcc

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
_SIGNATURES = {
    # (desc, n_chunks, sha, crc, stream)
    "spot_chunk_digest": (_P, _I64, _P, _P, _P),
    # (int[5] out) -> the chunk digest's launch layout
    "spot_chunk_digest_layout": (_P,),
    # (mode, iters, clocks, sink, stream): a dependent chain timed on one
    # thread (the rounds' rotate-and-add, whole rounds)
    "spot_chunk_digest_chain_clocks": (_I32, _I32, _P, _P, _P),
    # (x, nbytes, itemsize, block_bytes, slice_bytes, n_blocks, partial, stream)
    "spot_fingerprint_partials": (_P, _I64, _I32, _I64, _I64, _I64, _P, _P),
    # (partial, n_blocks, slices_per_block, out, old|NULL, diff|NULL, stream)
    "spot_fingerprint_final": (_P, _I64, _I64, _P, _P, _P, _P),
    # () -> the partial kernel's resident grid
    "spot_fingerprint_grid": (),
    # (x, n, dtype_code, partial, n_partial, out, stream)
    "spot_absmax": (_P, _I64, _I32, _P, _I32, _P, _P),
    # (dtype_code) -> absmax's first-pass grid on a large tensor
    "spot_absmax_grid": (_I32,),
    # (x, n, dtype_code, inv, q, stream)
    "spot_quantize": (_P, _I64, _I32, _F32, _P, _P),
    # (q, n, scale, dtype_code, out, stream)
    "spot_dequantize": (_P, _I64, _F32, _I32, _P, _P),
    # (dtype_code, int[4] out) -> dequantize's resident grid and trip
    "spot_dequantize_layout": (_I32, _P),
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
    # (hd) -> dynamic shared memory bytes of the tensor-core kernels: bf16
    # (wgmma) and float32 (3xTF32)
    "spot_flash_attention_fwd_wgmma_smem": (_I32,),
    "spot_flash_attention_dkv_wgmma_smem": (_I32,),
    "spot_flash_attention_dq_wgmma_smem": (_I32,),
    "spot_flash_attention_fwd_tf32x3_smem": (_I32,),
    "spot_flash_attention_dkv_tf32x3_smem": (_I32,),
    "spot_flash_attention_dq_tf32x3_smem": (_I32,),
    # (q, k, v, partials, B, S, H, KV, hd, valid_len, splits,
    #  keys_per_split, dtype_code, scale * log2(e), stream)
    "spot_decode_split": (_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                          _I32, _I32, _I32, _F32, _P),
    # (partials, o, B, H, hd, splits, dtype_code, stream)
    "spot_decode_merge": (_P, _P, _I32, _I32, _I32, _I32, _I32, _P),
    # (a, b, h, h_last, B, S, W, dtype_code, stream)
    "spot_rglru_scan": (_P, _P, _P, _P, _I32, _I32, _I32, _I32, _P),
    # (B, W, dtype_code, int[6] out) -> the RG-LRU scan's launch layout
    "spot_rglru_scan_layout": (_I32, _I32, _I32, _P),
    # (u, dt, A, B, C, D, y, h_last, B, S, DI, N, ld_bc, dtype_code,
    #  bc_dtype_code, stream)
    "spot_ssm_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                      _I64, _I32, _I32, _P),
    # (DI, dtype_code, int[5] out) -> the scan's launch layout
    "spot_ssm_scan_layout": (_I32, _I32, _P),
}

# element-type codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
FLOAT_DTYPES = tuple(DTYPE_CODES)            # the checkpoint kernels
# the model kernels' template instances: the dtypes and head dimensions the
# models serve and train in, and no others (phi3-mini trains and serves at
# head dim 96)
SERVING_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 96, 128, 256)          # flash attention forward and backward
DECODE_HEAD_DIMS = (64, 96, 128, 256)   # flash decode
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


def set_build_dir(path) -> None:
    """Build and load the library in ``path`` from now on. Raises once the
    library is loaded from elsewhere: a process loads one library."""
    global _build_dir
    path = Path(path)
    with _lock:
        if _lib is not None and path != _build_dir:
            raise RuntimeError(f"the kernel library is already loaded from "
                               f"{_build_dir}; cannot move it to {path}")
        _build_dir = path


def build_dir() -> Path:
    return _build_dir


def _target() -> Path:
    return _build_dir / f"libspot_kernels-{_digest()}.so"


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, _build_seconds, _built
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA kernels need a GPU; none is available")
        import time
        _build_dir.mkdir(parents=True, exist_ok=True)
        target = _target()
        t0 = time.perf_counter()
        # the build runs under the lock on purpose: every launch needs the
        # library, and SpotTrainer builds it before its first step, so no
        # save path waits here
        with open(_build_dir / "build.lock", "w") as lockf:  # spotlint: ignore[SPOT031]
            fcntl.flock(lockf, fcntl.LOCK_EX)   # one build at a time across processes
            built = not target.exists()
            if built:
                _build(target)
            # a load is a use: the cache sweep removes what is old (one
            # metadata write, under the lock like the build above)
            for path in (target, target.with_suffix(".ptxas.log")):
                try:
                    os.utime(path)  # spotlint: ignore[SPOT031]
                except OSError:
                    pass
        _build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib, _built = lib, built
        return lib


def build_seconds() -> float | None:
    """Wall time the first ``library()`` call spent building/loading."""
    return _build_seconds


def built() -> bool | None:
    """Whether this process's ``library()`` ran ``nvcc`` (False: it loaded
    a library built before; None: not loaded yet)."""
    return _built


def ptxas_report() -> dict[str, dict[str, int]]:
    """{mangled kernel name: {"registers", "smem", "spill_stores",
    "spill_loads"}} from the ``ptxas -v`` output of the library's build
    ("smem": static shared memory only; the flash kernels' is dynamic)."""
    log = _target().with_suffix(".ptxas.log")
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


def ptxas_warnings() -> list[str]:
    """The warnings of the library's ``ptxas`` runs, each naming the
    kernel it concerns: a wgmma serialised around its registers or a
    divergent path, a register limit not met."""
    log = _target().with_suffix(".ptxas.log")
    return [line.strip() for line in
            (log.read_text().splitlines() if log.exists() else ())
            if "warning" in line.lower() or "Performance Loss" in line]


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


def kernel_output(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A contiguous tensor for a kernel that writes every element of it,
    left unwritten. Under ``torch.use_deterministic_algorithms`` a
    ``torch.empty`` is filled with NaN first
    (``torch.utils.deterministic.fill_uninitialized_memory``): a whole
    extra pass over the output, as long as a byte-bound kernel's own writes.
    No element here is read before the kernel writes it, so the storage is
    allocated bare and viewed."""
    storage = torch.UntypedStorage(math.prod(shape) * dtype.itemsize, device=device)
    return torch.empty(0, dtype=dtype, device=device).set_(storage, 0, tuple(shape))


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if any input requires grad: a raw kernel entry point records no
    backward, and no autograd graph may record silently through its plain
    version (the differentiable wrappers call it with grad disabled)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: inputs require grad, but this entry point "
                           "records no backward; call it under "
                           "torch.no_grad() or use its differentiable wrapper")
