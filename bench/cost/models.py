"""The operations a model's forward and backward passes require, from the
configuration's widths: the numerator of ``round_mfu``. Recomputation
(remat) is not counted, and neither are element-wise operations (bias,
activations, pooling, norms, softmax), which are a few per value against
the products' hundreds.
"""
from __future__ import annotations

from typing import Dict, Tuple


def cnn_layer_flops(model: Dict) -> list:
    """Forward multiply-add operations (2 per MAC) of each product layer of
    the paper's CNN for one image: VALID ``k × k`` convolutions,
    ``2 Ho Wo k² Cin Cout``, with a 2×2 pool after every second one; then
    the dense head, ``2 in out``. The CIFAR CNN: 1,555,200 + 14,450,688 +
    5,308,416 + 7,372,800 + 921,600 + 46,080 + 1,600 = 29,656,384."""
    h, w, c = model["input_shape"]
    k = model["conv_kernel"]
    out = []
    for i, c_out in enumerate(model["conv_channels"]):
        h, w = h - k + 1, w - k + 1
        out.append(2 * h * w * k * k * c * c_out)
        c = c_out
        if i % 2 == 1:
            h, w = h // 2, w // 2
    dims = [h * w * c, *model["dense_hidden"], model["n_classes"]]
    out += [2 * a * b for a, b in zip(dims[:-1], dims[1:])]
    return out


def cnn_train_flops(model: Dict) -> Tuple[int, int]:
    """``(forward, forward + backward)`` operations a trained image needs.
    The backward takes each layer's weight gradient (as many operations as
    its forward) and every input gradient but the first layer's, which
    nothing needs: 29,656,384 and 87,413,952 for the CIFAR CNN."""
    layers = cnn_layer_flops(model)
    fwd = sum(layers)
    return fwd, fwd + sum(layers) + sum(layers[1:])


def lm_train_flops(model: Dict, tokens: int) -> Tuple[float, float]:
    """``(forward, forward + backward)`` operations of a dense decoder LM
    over ``tokens`` tokens of sequences ``model["seq_len"]`` long.

    Per token and layer the products are ``2 d (H Dh + 2 KV Dh)`` (Q, K, V),
    ``2 H Dh d`` (O), ``2 · 3 d F`` (a gated MLP) and, for causal attention,
    ``2 · 2 H Dh · (S + 1) / 2`` on average (``Q Kᵀ`` and ``P V`` over the
    visible keys); the head is ``2 d V``. The backward takes every weight
    gradient (as many operations as the forward's products with weights)
    and every input gradient (as many again, attention's twice over)
    except the embedding's, a gather. The embedding and head are frozen:
    the head needs its input gradient and no weight gradient."""
    d, H, KV = model["d_model"], model["n_heads"], model["n_kv_heads"]
    Dh, F, L = model["head_dim"], model["d_ff"], model["n_layers"]
    V, S = model["vocab_size"], model["seq_len"]
    proj = 2 * d * (H * Dh + 2 * KV * Dh) + 2 * H * Dh * d + 2 * 3 * d * F
    attn = 2 * 2 * H * Dh * (S + 1) / 2
    head = 2 * d * V
    fwd = tokens * (L * (proj + attn) + head)
    bwd = tokens * (L * (2 * proj + 2 * attn) + head)
    return fwd, fwd + bwd
