"""Granite-4.0-H (``granitemoehybrid``) in plain float32 PyTorch: the
reference the port's hybrid stack is held to.

Written from the published description (the model's ``config.json`` and
the ``GraniteMoeHybrid`` modelling code's equations), with no kernel,
cache or batching of the port and no import of it.  ``cfg`` is a mapping
of the published keys (``hidden_size``, ``layer_types``,
``mamba_n_heads``, ``mamba_d_head``, ``mamba_d_state``, ``mamba_d_conv``,
``num_attention_heads``, ``num_key_value_heads``,
``num_experts_per_tok``, ``embedding_multiplier``,
``residual_multiplier``, ``attention_multiplier``, ``logits_scaling``,
``rms_norm_eps``) and ``expert_start``, the first routed expert that the
weights hold.  ``params`` is the port's parameter tree, read by path:
``embed`` (tied), ``final_norm``, ``layers`` (each layer's norms, MoE and
shared expert, stacked over all layers), ``mamba_layers`` and
``attn_layers`` (the mixers, stacked over the layers of their kind).
Each layer's weights are upcast to float32 as it runs.

* embedding ``h = E[tok] * embedding_multiplier``;
* each layer ``h += r * mixer(RMSNorm(h))``, then
  ``h += r * (MoE(x) + Shared(x))`` with ``x = RMSNorm(h)``;
* Mamba-2: ``xBC = silu(causal_conv(xBC) + b)``, ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``, the SSM recurrence one position at a
  time with the skip ``D``, then ``out_proj(RMSNorm(y * silu(z)))``;
* attention: causal GQA without rotary, scores ``q k^T *
  attention_multiplier``;
* MoE: the router's ``top_k`` logits over all routed experts, gates a
  softmax over them, each held expert's SwiGLU on the tokens routed to it
  (what experts outside the weights would add is left out); the shared
  expert the same SwiGLU on every token;
* logits ``RMSNorm(h) E^T / logits_scaling``.

Departures: the Mamba-2 input projection and conv are per stream (z, x,
B, C, dt), the port's layout of the same parameters.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MIXERS = {"mamba": "mamba_layers", "attention": "attn_layers"}


def upcast(tree, i: int):
    """Layer ``i`` of a stacked tree, in float32."""
    if isinstance(tree, dict):
        return {k: upcast(v, i) for k, v in tree.items()}
    return tree[i].float()


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def mamba(cfg, p, x):
    b, s, _ = x.shape
    nh, hd, k = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_conv"]

    def conv(u, w, bias):
        up = F.pad(u, (0, 0, k - 1, 0))
        return F.silu(sum(up[:, i:i + s] * w[i] for i in range(k)) + bias)

    z = x @ p["z_proj"]["kernel"]
    xs = conv(x @ p["x_proj"]["kernel"], p["conv_x"], p["conv_x_bias"])
    bm = conv(x @ p["b_proj"]["kernel"], p["conv_b"], p["conv_b_bias"])
    cm = conv(x @ p["c_proj"]["kernel"], p["conv_c"], p["conv_c_bias"])
    dt = F.softplus(x @ p["dt_proj"]["kernel"] + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(b, s, nh, hd)
    state = x.new_zeros((b, nh, hd, cfg["mamba_d_state"]))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)
        state = (state * decay[:, :, None, None]
                 + (xh[:, t] * dt[:, t, :, None])[..., None] * bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    y = (torch.stack(ys, 1) + xh * p["d_skip"][:, None]).reshape(b, s, nh * hd)
    y = rms_norm(y * F.silu(z), p["norm_scale"], cfg["rms_norm_eps"])
    return y @ p["out_proj"]["kernel"]


def attention(cfg, p, x):
    b, s, d = x.shape
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nq
    q = (x @ p["q"]["kernel"]).reshape(b, s, nq, hd).transpose(1, 2)
    k = (x @ p["k"]["kernel"]).reshape(b, s, nkv, hd).transpose(1, 2)
    v = (x @ p["v"]["kernel"]).reshape(b, s, nkv, hd).transpose(1, 2)
    k = k.repeat_interleave(nq // nkv, dim=1)
    v = v.repeat_interleave(nq // nkv, dim=1)
    scores = q @ k.transpose(-1, -2) * cfg["attention_multiplier"]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    return out.transpose(1, 2).reshape(b, s, nq * hd) @ p["o"]["kernel"]


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def router(cfg, p, x):
    """Each token's ``(top_k expert ids, gates, logits)``."""
    logits = x.reshape(-1, x.shape[-1]) @ p["router"]
    top, idx = torch.topk(logits, cfg["num_experts_per_tok"], dim=-1)
    return idx, torch.softmax(top, dim=-1), logits


def moe(cfg, p, x, routes=None):
    """The held experts' part; ``routes`` (a list) gets the router's logits."""
    xt = x.reshape(-1, x.shape[-1])
    idx, gates, logits = router(cfg, p, x)
    if routes is not None:
        routes.append(logits)
    out = torch.zeros_like(xt)
    start = cfg.get("expert_start", 0)
    for j in range(p["gate"].shape[0]):
        w = (gates * (idx == start + j)).sum(-1)
        rows = w.nonzero()[:, 0]
        if len(rows):
            out[rows] += swiglu(xt[rows], p["gate"][j], p["up"][j], p["down"][j]) * w[rows, None]
    return out.reshape(x.shape)


def kind_index(cfg, i: int) -> tuple[str, int]:
    """Layer ``i``'s mixer kind and its index among the layers of that kind."""
    kind = cfg["layer_types"][i]
    return kind, cfg["layer_types"][:i].count(kind)


def layer_weights(cfg, params, i: int):
    """Layer ``i``'s own weights and its mixer's, in float32."""
    kind, j = kind_index(cfg, i)
    return upcast(params["layers"], i), upcast(params[MIXERS[kind]], j)


def layer(cfg, params, i: int, h, routes=None):
    """Layer ``i`` on its float32 input ``h`` (B, S, D); ``routes`` (a
    list) gets the router's logits (B * S, experts)."""
    kind, _ = kind_index(cfg, i)
    p, mp = layer_weights(cfg, params, i)
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = rms_norm(h, p["norm1"]["scale"], eps)
    h = h + r * (mamba(cfg, mp, x) if kind == "mamba" else attention(cfg, mp, x))
    x = rms_norm(h, p["norm2"]["scale"], eps)
    s = p["shared"]
    return h + r * (moe(cfg, p["moe"], x, routes)
                    + swiglu(x, s["gate"]["kernel"], s["up"]["kernel"], s["down"]["kernel"]))


def embed(cfg, params, tokens):
    return params["embed"][tokens].float() * cfg["embedding_multiplier"]


def logits(cfg, params, h):
    h = rms_norm(h, params["final_norm"]["scale"], cfg["rms_norm_eps"])
    return h @ params["embed"].float().T / cfg["logits_scaling"]


def forward(cfg, params, tokens, keep_inputs: bool = False):
    """Logits (B, S, V) of ``tokens`` (B, S); with ``keep_inputs`` also each
    layer's input and the last layer's output (``n_layers + 1`` tensors)
    and each layer's router logits."""
    h = embed(cfg, params, tokens)
    hs, routes = [h], []
    for i in range(len(cfg["layer_types"])):
        h = layer(cfg, params, i, h, routes if keep_inputs else None)
        if keep_inputs:
            hs.append(h)
    out = logits(cfg, params, h)
    return (out, hs, routes) if keep_inputs else out
