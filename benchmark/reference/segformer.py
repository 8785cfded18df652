"""SegFormer in plain float32 PyTorch, as functions over a flax-layout tree.

The published model (Xie et al., NeurIPS 2021, arXiv:2105.15203;
NVlabs/SegFormer ``mix_transformer.py`` and ``segformer_head.py``), with a
head of ``num_classes`` logits: four stages of an overlapping patch
embedding (conv 7x7 stride 4 padding 3, then 3x3 stride 2 padding 1,
each followed by a LayerNorm of eps 1e-5), blocks of efficient
self-attention and Mix-FFN (``x += proj(attn(LN(x)))``, ``x +=
fc2(GELU(dwconv3x3(fc1(LN(x)))))``, the block LayerNorms of eps 1e-6; keys
and values from the tokens reduced by a conv of kernel and stride ``sr``
and a LayerNorm of eps 1e-5 where ``sr`` > 1; scale ``head_dim ** -0.5``
on the scores), a LayerNorm of eps 1e-6 closing each stage; the All-MLP
head (a Linear from each stage to the head's width, bilinear resizes to
1/4, ``align_corners=False``, concatenated c4, c3, c2, c1, a 1x1 conv
without bias, BatchNorm and ReLU, a 1x1 classifier), and the logits
resized bilinearly to the image's size, where the loss is taken.

The tree is ``{"params", "batch_stats"}``: conv kernels HWIO, Linear
kernels ``[in, out]``, LayerNorms ``scale`` / ``bias``, the head's
BatchNorm ``scale`` / ``bias`` and running ``mean`` / ``var``. Written
from the description, independent of the program it checks; it reads the
weights the program is handed.

Departures from the published code, none of which changes the arithmetic
of a step: stochastic depth and dropout at 0; attention computed in blocks
of ``query_block`` queries, so that a 1024x1024 image's scores fit beside
everything else on one card.

BatchNorm is PyTorch's: in training the moments are the batch's (biased
variance, two-pass) and the running statistics move by momentum 0.1 with
the unbiased variance; eps 1e-5.

``tf32=True`` rounds both operands of every convolution and every matrix
product (the Linears and the attention's two) to TF32 (10 mantissa bits)
and accumulates in float32, forward and backward: the reference computed
one precision below the float32 (TF32 off) that the configuration states.
It is the comparison's control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.resunet import conv, get, round_tf32, set_leaf

PATCH = ((7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1))     # kernel, stride, padding a stage
PATCH_EPS, BLOCK_EPS, SR_EPS, BN_EPS = 1e-5, 1e-6, 1e-5, 1e-5
BN_MOMENTUM = 0.1
QUERY_BLOCK = 8192


def leaf_specs(embed_dims, depths, sr_ratios, mlp_ratio: int, decoder_dim: int, in_channels: int = 3,
               num_classes: int = 1) -> list[tuple[tuple[str, ...], tuple[int, ...], str]]:
    """Every leaf of the variables tree as ``(path, shape, kind)``; kind is
    ``conv`` (with the fan-out in the shape), ``dense`` (a Linear's kernel,
    and the classifier's 1x1 kernel, a per-pixel Linear), ``bias``,
    ``ln_scale``, ``ln_bias``, ``bn_scale``, ``bn_bias``, ``bn_mean`` or
    ``bn_var``. The order is the published module order."""
    specs: list = []

    def conv_leaf(path, k, cin_g, cout, bias=True, kind="conv"):
        specs.append((("params",) + path + ("kernel",), (k, k, cin_g, cout), kind))
        if bias:
            specs.append((("params",) + path + ("bias",), (cout,), "bias"))

    def dense(path, cin, cout):
        specs.append((("params",) + path + ("kernel",), (cin, cout), "dense"))
        specs.append((("params",) + path + ("bias",), (cout,), "bias"))

    def ln(path, c):
        specs.append((("params",) + path + ("scale",), (c,), "ln_scale"))
        specs.append((("params",) + path + ("bias",), (c,), "ln_bias"))

    cin = in_channels
    for i, dim in enumerate(embed_dims):
        s = i + 1
        conv_leaf((f"patch_embed{s}", "proj"), PATCH[i][0], cin, dim)
        ln((f"patch_embed{s}", "norm"), dim)
        hidden = dim * mlp_ratio
        for j in range(depths[i]):
            b = f"block{s}_{j}"
            ln((b, "norm1"), dim)
            dense((b, "attn", "q"), dim, dim)
            dense((b, "attn", "kv"), dim, 2 * dim)
            dense((b, "attn", "proj"), dim, dim)
            if sr_ratios[i] > 1:
                conv_leaf((b, "attn", "sr"), sr_ratios[i], dim, dim)
                ln((b, "attn", "norm"), dim)
            ln((b, "norm2"), dim)
            dense((b, "mlp", "fc1"), dim, hidden)
            conv_leaf((b, "mlp", "dwconv"), 3, 1, hidden)
            dense((b, "mlp", "fc2"), hidden, dim)
        ln((f"norm{s}",), dim)
        cin = dim
    for i in (4, 3, 2, 1):
        dense(("head", f"linear_c{i}"), embed_dims[i - 1], decoder_dim)
    conv_leaf(("head", "linear_fuse"), 1, 4 * decoder_dim, decoder_dim, bias=False)
    specs.append((("params", "head", "bn", "scale"), (decoder_dim,), "bn_scale"))
    specs.append((("params", "head", "bn", "bias"), (decoder_dim,), "bn_bias"))
    conv_leaf(("head", "linear_pred"), 1, decoder_dim, num_classes, kind="dense")
    specs.append((("batch_stats", "head", "bn", "mean"), (decoder_dim,), "bn_mean"))
    specs.append((("batch_stats", "head", "bn", "var"), (decoder_dim,), "bn_var"))
    return specs


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ar, br = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ar, br)
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = round_tf32(g)
        return torch.matmul(gr, br.transpose(-2, -1)), torch.matmul(ar.transpose(-2, -1), gr)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``a @ b`` over matching leading axes."""
    return _Tf32Matmul.apply(a, b) if tf32 else torch.matmul(a, b)


def dense(x: torch.Tensor, p: dict, tf32: bool) -> torch.Tensor:
    return matmul(x, p["kernel"], tf32) + p["bias"]


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def conv_nchw(x: torch.Tensor, p: dict, stride: int, padding: int, groups: int, tf32: bool) -> torch.Tensor:
    x = F.pad(x, (padding,) * 4) if padding else x
    return conv(x, p["kernel"], p.get("bias"), stride=stride, groups=groups, tf32=tf32)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, tf32: bool,
              query_block: int = QUERY_BLOCK) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` per head, ``query_block`` queries at a
    time."""
    kt = k.transpose(-2, -1)
    out = []
    for lo in range(0, q.shape[2], query_block):
        scores = matmul(q[:, :, lo:lo + query_block], kt, tf32) * scale
        out.append(matmul(torch.softmax(scores, dim=-1), v, tf32))
    return torch.cat(out, dim=2)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


def _grid(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def block(x: torch.Tensor, p: dict, h: int, w: int, heads: int, *, tf32: bool = False,
          query_block: int = QUERY_BLOCK) -> torch.Tensor:
    """One Mix Transformer block on tokens ``[B, h * w, C]`` under its
    params ``p`` (``norm1``, ``attn``, ``norm2``, ``mlp``)."""
    b, n, c = x.shape
    d = c // heads
    a = p["attn"]
    y = layer_norm(x, p["norm1"], BLOCK_EPS)
    q = dense(y, a["q"], tf32).reshape(b, n, heads, d).permute(0, 2, 1, 3)
    if "sr" in a:
        sr = a["sr"]["kernel"].shape[0]
        y = layer_norm(_tokens(conv_nchw(_grid(y, h, w), a["sr"], sr, 0, 1, tf32)), a["norm"], SR_EPS)
    kv = dense(y, a["kv"], tf32).reshape(b, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
    o = attention(q, kv[0], kv[1], d ** -0.5, tf32, query_block)
    x = x + dense(o.transpose(1, 2).reshape(b, n, c), a["proj"], tf32)
    m = p["mlp"]
    y = dense(layer_norm(x, p["norm2"], BLOCK_EPS), m["fc1"], tf32)
    y = _tokens(conv_nchw(_grid(y, h, w), m["dwconv"], 1, 1, y.shape[2], tf32))
    return x + dense(F.gelu(y), m["fc2"], tf32)


def forward(variables: dict, images: torch.Tensor, num_heads, *, train: bool = False, tf32: bool = False,
            query_block: int = QUERY_BLOCK) -> tuple[torch.Tensor, dict | None]:
    """Logits ``[N, H, W, classes]`` of float32 NHWC images in [0, 1]. In
    training (``train=True``) also the new ``batch_stats`` tree."""
    # Float32 products: TF32 off for cuDNN's convolutions and cuBLAS.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p = variables["params"]
    n_img, h_img, w_img = images.shape[:3]
    x = images.permute(0, 3, 1, 2).contiguous()
    feats = []
    for i in range(len(num_heads)):
        s = i + 1
        k, stride, pad = PATCH[i]
        x = conv_nchw(x, p[f"patch_embed{s}"]["proj"], stride, pad, 1, tf32)
        h, w = x.shape[2:]
        x = layer_norm(_tokens(x), p[f"patch_embed{s}"]["norm"], PATCH_EPS)
        j = 0
        while f"block{s}_{j}" in p:
            x = block(x, p[f"block{s}_{j}"], h, w, num_heads[i], tf32=tf32, query_block=query_block)
            j += 1
        x = _grid(layer_norm(x, p[f"norm{s}"], BLOCK_EPS), h, w)
        feats.append(x)
    hd = p["head"]
    size = feats[0].shape[2:]
    maps = []
    for i in (4, 3, 2, 1):
        f = feats[i - 1]
        t = _grid(dense(_tokens(f), hd[f"linear_c{i}"], tf32), f.shape[2], f.shape[3])
        maps.append(t if i == 1 else _resize(t, size))
    y = conv_nchw(torch.cat(maps, dim=1), hd["linear_fuse"], 1, 0, 1, tf32)
    stats = variables["batch_stats"]["head"]["bn"]
    new_stats = None
    if train:
        var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
        count = y.numel() // y.shape[1]
        new_stats = {"head": {"bn": {
            "mean": (1.0 - BN_MOMENTUM) * stats["mean"] + BN_MOMENTUM * mean.detach(),
            "var": (1.0 - BN_MOMENTUM) * stats["var"] + BN_MOMENTUM * var.detach() * (count / (count - 1)),
        }}}
    else:
        mean, var = stats["mean"], stats["var"]
    bn = hd["bn"]
    y = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS) * bn["scale"][:, None, None] \
        + bn["bias"][:, None, None]
    logits = conv_nchw(torch.relu(y), hd["linear_pred"], 1, 0, 1, tf32)
    logits = _resize(logits, (h_img, w_img)).permute(0, 2, 3, 1)
    return logits, new_stats


__all__ = ["block", "forward", "get", "leaf_specs", "set_leaf"]
