"""The yardstick: the card's peaks and the operations and bytes of the
work the metrics divide by.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
its full 700 W; a card set to a lower power limit runs below them, which
the result line's power limit shows.  The operation counts follow the
port's shapes: :func:`cnn_sample_flops` is the paper's CNN (valid
padding), :func:`lm_step_flops` an LM train step of the port's layer
equations, :func:`flash_bytes_ops` one call of the flash kernel and
:func:`fused_round_bytes` the fused coalition round's two passes.
"""
from __future__ import annotations

#: FLOP/s and bytes/s of one H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "fp8": 1979e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def cnn_forward_macs(c1: int = 32, c2: int = 64, kernel: int = 5,
                     fc: int = 512, n_classes: int = 10,
                     in_hw: int = 28) -> dict[str, int]:
    """Multiply-adds of each layer for one image, valid padding, 2x2 pools."""
    o1 = in_hw - kernel + 1                       # 24
    p1 = o1 // 2                                  # 12
    o2 = p1 - kernel + 1                          # 8
    flat = (o2 // 2) ** 2 * c2                    # 1024
    return {"conv1": o1 * o1 * c1 * kernel * kernel,
            "conv2": o2 * o2 * c2 * kernel * kernel * c1,
            "fc1": flat * fc, "fc2": fc * n_classes}


def cnn_sample_flops(**cfg) -> int:
    """FLOPs of one sample's SGD step: the forward, the weight gradients
    (as many again) and the input gradients of every layer but the first
    (24,680,448 at the paper's sizes)."""
    macs = cnn_forward_macs(**cfg)
    fwd = 2 * sum(macs.values())
    dgrad = 2 * (macs["conv2"] + macs["fc1"] + macs["fc2"])
    return 2 * fwd + dgrad


def lm_linear_params(cfg) -> int:
    """Parameters that take part in matrix products once a token: the
    layers' projections and the tied (or separate) output head."""
    d, dh, hq, hkv = cfg["d_model"], cfg["d_head"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    di = cfg["ssm_expand"] * d
    n, dr = cfg["ssm_state"], cfg["dt_rank"]
    per_layer = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    if cfg.get("hybrid") or cfg.get("ssm"):
        per_layer += d * 2 * di + di * (dr + 2 * n) + dr * di + di * d
    per_layer += 3 * d * cfg["d_ff"]
    return cfg["n_layers"] * per_layer + cfg["vocab"] * d


def attention_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs a causal, optionally windowed mask keeps."""
    return sum(min(q + 1, window or q + 1) for q in range(s))


def lm_step_flops(cfg, batch: int, seq: int) -> int:
    """Model FLOPs of one train step (forward and backward, nothing
    recomputed): 6 a linear parameter and token, the causal attention's
    two products (4·Dh a head and kept pair, three times), and the
    selective scan's state update and readout (2 a state element and step
    forward, 6 backward)."""
    tokens = batch * seq
    att = 3 * 4 * batch * cfg["n_heads"] * cfg["d_head"] * \
        attention_pairs(seq, cfg.get("window"))
    scan = 0
    if cfg.get("hybrid") or cfg.get("ssm"):
        scan = 8 * batch * seq * cfg["ssm_expand"] * cfg["d_model"] * \
            cfg["ssm_state"]
    return 6 * lm_linear_params(cfg) * tokens + cfg["n_layers"] * (att + scan)


def flash_bytes_ops(b: int, hq: int, hkv: int, s: int, dh: int,
                    window: int | None, elt: int = 2) -> tuple[int, int]:
    """One causal self-attention call: bytes (q read and o written, k and
    v read once, ``elt`` bytes a value) and operations (4·Dh a kept pair
    and head)."""
    nbytes = elt * (2 * b * hq * s * dh + 2 * b * hkv * s * dh)
    ops = 4 * b * hq * dh * attention_pairs(s, window)
    return nbytes, ops


def roofline_s(nbytes: float, ops: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_flops)


def fused_round_bytes(n: int, k: int, d: int, elt: int = 4) -> int:
    """The fused round's two passes: W read once by each; pass 1 reads
    the (K, N) centre matrix and writes (N, K) distances, pass 2 reads the
    (K, N) mixing matrix and writes b (K, D), θ (D,) and (N, K) f32."""
    w = n * d * elt
    small = 4 * (k * n + n * k)
    return 2 * w + 2 * small + 4 * (k * d + d)
