"""Roofline bookkeeping: model FLOPs counted from the config, the
collective bytes of a traced step, and the three roofline terms on the
H100's published rates (``launch/mesh.py``).

The counts are the reference's (``launch/roofline.py``) term for term, so
a model-FLOP figure means the same in both packages. Each term is a
per-device quantity over a per-card rate: ``compute = flops / peak``,
``memory = bytes / HBM``, ``collective = collective bytes / NVLink``.
"""

from __future__ import annotations

from ..models.config import ModelConfig, RGLRUConfig, SSMConfig
from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def active_matmul_params(cfg: ModelConfig) -> int:
    """Per-token matmul parameters: routed experts counted at top_k (+shared),
    embedding lookup excluded, lm_head included, norms ignored."""
    D, F = cfg.d_model, cfg.d_ff
    n_mats = 3 if cfg.mlp_gated else 2
    total = 0
    prelude = cfg.moe.dense_prelude_layers if cfg.moe else 0
    for li, kind in enumerate(cfg.layer_kinds()):
        if kind in ("global", "local"):
            total += D * cfg.q_dim + 2 * D * cfg.kv_dim + cfg.q_dim * D
            if cfg.moe is not None and li >= prelude:
                m = cfg.moe
                total += D * m.n_experts
                total += (m.top_k + m.n_shared) * n_mats * D * m.d_expert
            else:
                f = cfg.moe.d_ff_prelude if (cfg.moe and li < prelude) else F
                total += n_mats * D * f
        elif kind == "mamba":
            s = cfg.ssm or SSMConfig()
            di = s.expand * D
            dt = s.resolved_dt_rank(D)
            total += D * 2 * di + di * s.d_conv + di * (dt + 2 * s.d_state)
            total += dt * di + di * D
        elif kind == "rglru":
            r = cfg.rglru or RGLRUConfig()
            W = r.lru_width or D
            nb = r.n_blocks or cfg.n_heads
            total += 2 * D * W + W * r.d_conv + 2 * nb * (W // nb) ** 2 + W * D
            total += n_mats * D * F
    total += cfg.d_model * cfg.vocab_size  # lm head
    return total


def _attn_context_sum(cfg: ModelConfig, S: int) -> float:
    """Sum over layers of sum_i ctx(i) for a causal prefill of length S."""
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind == "global":
            total += S * (S + 1) / 2
        elif kind == "local":
            W = cfg.window or S
            if S <= W:
                total += S * (S + 1) / 2
            else:
                total += W * (W + 1) / 2 + (S - W) * W
    return total


def _scan_flops_per_token(cfg: ModelConfig) -> float:
    """Elementwise recurrence flops per token (mamba/rglru layers)."""
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind == "mamba":
            s = cfg.ssm or SSMConfig()
            total += 10.0 * (s.expand * cfg.d_model) * s.d_state
        elif kind == "rglru":
            r = cfg.rglru or RGLRUConfig()
            total += 12.0 * (r.lru_width or cfg.d_model)
    return total


def model_flops(cfg: ModelConfig, *, kind: str, batch: int, seq_len: int) -> float:
    """Analytic model FLOPs of one step of the given cell (global, not
    per-device). train = 3x forward (the 6ND convention)."""
    N = active_matmul_params(cfg)
    if kind == "train":
        tokens = batch * seq_len
        mm = 2.0 * N * tokens
        attn = 4.0 * cfg.n_heads * cfg.head_dim * batch * _attn_context_sum(cfg, seq_len)
        scan = _scan_flops_per_token(cfg) * tokens
        return 3.0 * (mm + attn + scan)
    if kind == "prefill":
        tokens = batch * seq_len
        mm = 2.0 * N * tokens
        attn = 4.0 * cfg.n_heads * cfg.head_dim * batch * _attn_context_sum(cfg, seq_len)
        return mm + attn + _scan_flops_per_token(cfg) * tokens
    if kind == "decode":
        mm = 2.0 * N * batch
        ctx = 0.0
        for k in cfg.layer_kinds():
            if k == "global":
                ctx += seq_len
            elif k == "local":
                ctx += min(cfg.window or seq_len, seq_len)
        attn = 4.0 * cfg.n_heads * cfg.head_dim * batch * ctx
        return mm + attn + _scan_flops_per_token(cfg) * batch
    raise ValueError(kind)


COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute", "ragged-all-to-all")


def collective_bytes(records) -> dict:
    """Per-device operand bytes of the collectives recorded in a trace
    (``(kind, bytes)`` pairs, ``OpAnalysis.collectives``), by kind and
    count: the reference's shape, every one of its kinds a key."""
    out = {k: 0.0 for k in COLL_KINDS}
    counts = {k: 0 for k in COLL_KINDS}
    for kind, n in records:
        out[kind] += n
        counts[kind] += 1
    return {"by_kind": out, "counts": counts, "total": sum(out.values())}


def roofline_terms(*, per_device_flops: float, per_device_bytes: float,
                   per_device_coll_bytes: float) -> dict:
    """The compute, memory and collective seconds of one device's work on
    one H100, the dominant term, and the bound (the largest term)."""
    compute_s = per_device_flops / PEAK_FLOPS_BF16
    memory_s = per_device_bytes / HBM_BW
    coll_s = per_device_coll_bytes / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant.replace("_s", ""),
            "bound_s": terms[dominant]}
