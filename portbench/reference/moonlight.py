"""Moonlight-16B-A3B in plain float32 PyTorch: the news encoder of the
``moonlight16b-latent2048`` configuration
(https://huggingface.co/moonshotai/Moonlight-16B-A3B, its ``config.json``;
DeepSeek-V3's layout, ``model_type`` deepseek_v3).

Token embeddings; per layer a pre-norm (RMSNorm) multi-head latent
attention and a pre-norm feed-forward, each added to the residual stream; a
final RMSNorm; the state of each row's last real token; the L2 norm.

- Attention (no q LoRA): ``q_proj`` gives each of the 16 heads 128 plain
  and 64 rotary query dims; ``kv_a_proj_with_mqa`` gives a 512-wide latent,
  RMSNorm'd (``kv_a_layernorm``), and one 64-wide rotary key shared by the
  heads; ``kv_b_proj`` makes each head's 128 plain key dims and 128 value
  dims from the latent. The rotary dims come in interleaved pairs and are
  de-interleaved (evens, then odds) before the rotate-half rotation (theta
  50,000, no scaling). Softmax scale 192 ** -0.5, causal and padding mask;
  ``o_proj``.
- Feed-forward: layers before ``first_k_dense_replace`` a SwiGLU of 11,264
  (``down(silu(gate x) * up x)``); the others a mixture of 64 SwiGLU
  experts of 1,408: the router's scores ``sigmoid(x W_r^T)``, the 6 experts
  of the highest ``score + e_score_correction_bias``, weighted by their
  unbiased scores renormalised to sum 1 and scaled by 2.446; plus the
  shared experts, one SwiGLU of 2 x 1,408 over every token.

Departures, each where this file and the program agree against the source:

- the weights are bfloat16 values (the configuration's precision), read
  here as float32, and random from the seed (no checkpoint is in the
  repository); the selection bias is drawn at ``BIAS_SCALE``;
- Moonlight has no embedding head: it pools at the last real token, as the
  port pools every causal decoder.

Parameter names are the port's ``NewsEncoder`` ``state_dict`` names (the
experts stacked: ``experts.gate_up_proj`` [E, 2I, D], each expert's gate
rows then its up rows, and ``experts.down_proj`` [E, D, I]). No import of
the port, its kernels or JAX. Every product is a plain ``torch`` operation
through ``nvembed.Products``, which can round its operands (the controls);
the weights are upcast one layer at a time, so the reference fits beside
the program's bfloat16 weights on one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference.nvembed import Products, rms_norm, rotary, rotate_half

# The draw of e_score_correction_bias (Moonlight's values are not public):
# normal with this standard deviation, at which the bias changes the top-6
# of 87-88% of (token, layer) pairs at the cell's size (the ``bias_ignored``
# control of ``tools/moonlight_control.py``).
BIAS_SCALE = 0.05


def widths(hf: dict) -> dict:
    """The sizes of a DeepSeek-V3 ``config.json`` under short names."""
    return {
        "vocab": hf["vocab_size"], "d": hf["hidden_size"], "layers": hf["num_hidden_layers"],
        "heads": hf["num_attention_heads"], "nope": hf["qk_nope_head_dim"], "rope": hf["qk_rope_head_dim"],
        "vd": hf["v_head_dim"], "rank": hf["kv_lora_rank"], "ffn": hf["intermediate_size"],
        "experts": hf["n_routed_experts"], "top_k": hf["num_experts_per_tok"], "moe_ffn": hf["moe_intermediate_size"],
        "shared": hf["n_shared_experts"] * hf["moe_intermediate_size"], "dense": hf["first_k_dense_replace"],
        "scaling": hf["routed_scaling_factor"], "eps": hf.get("rms_norm_eps", 1e-6), "theta": hf["rope_theta"],
    }


def param_shapes(hf: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Name -> (shape, init kind) of every parameter, in the port's order."""
    w = widths(hf)
    d, h, e, i = w["d"], w["heads"], w["experts"], w["moe_ffn"]
    out = {"embed_tokens.weight": ((w["vocab"], d), "normal")}
    for layer in range(w["layers"]):
        p = f"layers.{layer}."
        out.update({
            p + "input_layernorm.weight": ((d,), "norm_weight"),
            p + "self_attn.q_proj.weight": ((h * (w["nope"] + w["rope"]), d), "linear"),
            p + "self_attn.kv_a_proj_with_mqa.weight": ((w["rank"] + w["rope"], d), "linear"),
            p + "self_attn.kv_a_layernorm.weight": ((w["rank"],), "norm_weight"),
            p + "self_attn.kv_b_proj.weight": ((h * (w["nope"] + w["vd"]), w["rank"]), "linear"),
            p + "self_attn.o_proj.weight": ((d, h * w["vd"]), "linear"),
            p + "post_attention_layernorm.weight": ((d,), "norm_weight"),
        })
        if layer < w["dense"]:
            out.update({
                p + "mlp.gate_proj.weight": ((w["ffn"], d), "linear"),
                p + "mlp.up_proj.weight": ((w["ffn"], d), "linear"),
                p + "mlp.down_proj.weight": ((d, w["ffn"]), "linear"),
            })
        else:
            out.update({
                p + "mlp.gate.weight": ((e, d), "linear"),
                p + "mlp.gate.e_score_correction_bias": ((e,), "normal"),
                p + "mlp.experts.gate_up_proj": ((e, 2 * i, d), "linear"),
                p + "mlp.experts.down_proj": ((e, d, i), "linear"),
                p + "mlp.shared_experts.gate_proj.weight": ((w["shared"], d), "linear"),
                p + "mlp.shared_experts.up_proj.weight": ((w["shared"], d), "linear"),
                p + "mlp.shared_experts.down_proj.weight": ((d, w["shared"]), "linear"),
            })
    out["norm.weight"] = ((d,), "norm_weight")
    return out


def draw(hf: dict, gen: torch.Generator, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Every parameter, one at a time (``weights.make_params``' rules), in
    ``dtype``; the selection biases N(0, 1) times ``BIAS_SCALE``."""
    out = {}
    for name, spec in param_shapes(hf).items():
        x = weights.make_params({name: spec}, gen, device)[name]
        if name.endswith("e_score_correction_bias"):
            x = x * BIAS_SCALE
        out[name] = x.to(dtype)
    return out


def param_count(hf: dict, embeddings: bool = True) -> int:
    """The parameters ``param_shapes`` lists (no LM head)."""
    n = sum(int(torch.Size(s).numel()) for s, _ in param_shapes(hf).values())
    return n if embeddings else n - hf["vocab_size"] * hf["hidden_size"]


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (x0, x2, ..., x1, x3, ...) on the last axis."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def _layer(p: dict, layer: int) -> dict:
    """Layer ``layer``'s weights as float32, under names without the prefix."""
    pre = f"layers.{layer}."
    return {k[len(pre):]: v.float() for k, v in p.items() if k.startswith(pre)}


def attention(lw: dict, w: dict, x: torch.Tensor, cos, sin, bias, prod: Products, kv_norm: bool = True,
              interleaved: bool = True) -> torch.Tensor:
    """The multi-head latent attention of one block [B, T, D] (its input
    already normed)."""
    b, t, _ = x.shape
    h, nope, rope, vd, rank = w["heads"], w["nope"], w["rope"], w["vd"], w["rank"]
    q = prod.linear(x, lw["self_attn.q_proj.weight"]).view(b, t, h, nope + rope).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    latent, k_pe = prod.linear(x, lw["self_attn.kv_a_proj_with_mqa.weight"]).split([rank, rope], dim=-1)
    if kv_norm:
        latent = rms_norm(latent, lw["self_attn.kv_a_layernorm.weight"], w["eps"])
    kv = prod.linear(latent, lw["self_attn.kv_b_proj.weight"]).view(b, t, h, nope + vd).transpose(1, 2)
    k_nope, v = kv.split([nope, vd], dim=-1)
    k_pe = k_pe.view(b, 1, t, rope)
    if interleaved:
        q_pe, k_pe = deinterleave(q_pe), deinterleave(k_pe)
    q_pe, k_pe = q_pe * cos + rotate_half(q_pe) * sin, k_pe * cos + rotate_half(k_pe) * sin
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, h, t, rope)], dim=-1)
    probs = torch.softmax(prod.matmul(q, k.transpose(-1, -2)) * (nope + rope) ** -0.5 + bias, dim=-1)
    ctx = prod.matmul(probs, v).transpose(1, 2).reshape(b, t, h * vd)
    return prod.linear(ctx, lw["self_attn.o_proj.weight"])


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, prod: Products) -> torch.Tensor:
    return prod.linear(F.silu(prod.linear(x, gate)) * prod.linear(x, up), down)


def moe(lw: dict, w: dict, x: torch.Tensor, prod: Products, forced: torch.Tensor | None = None,
        top_k: int | None = None, bias: bool = True, renormalize: bool = True, scale: bool = True,
        shared: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixture of experts over [N, D] tokens (normed): its output and
    the experts each token picks by its own scores [N, k], sorted. With
    ``forced`` [N, k'] the experts applied are those (another forward pass's
    picks), weighted by this pass's own scores of them. The controls:
    ``top_k`` experts a token, the selection ``bias`` left out, the weights
    not ``renormalize``d or not ``scale``d, the ``shared`` experts left
    out."""
    k, i = top_k or w["top_k"], w["moe_ffn"]
    scores = torch.sigmoid(prod.linear(x, lw["mlp.gate.weight"]))
    choice = scores + lw["mlp.gate.e_score_correction_bias"] if bias else scores
    own = torch.topk(choice, k, dim=-1).indices
    picked = own if forced is None else forced
    weight = scores.gather(1, picked)
    if renormalize:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    if scale:
        weight = weight * w["scaling"]
    y = torch.zeros_like(x)
    gate_up, down = lw["mlp.experts.gate_up_proj"], lw["mlp.experts.down_proj"]
    for e in range(gate_up.shape[0]):
        rows, slot = torch.nonzero(picked == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        out = swiglu(x[rows], gate_up[e, :i], gate_up[e, i:], down[e], prod)
        y.index_add_(0, rows, out * weight[rows, slot, None])
    if shared:
        y = y + swiglu(x, lw["mlp.shared_experts.gate_proj.weight"], lw["mlp.shared_experts.up_proj.weight"],
                       lw["mlp.shared_experts.down_proj.weight"], prod)
    return y, own.sort(dim=-1).values


@torch.no_grad()
def encode_blocks(p: dict, hf: dict, blocks: list, prod: Products | None = None, routes: list | None = None,
                  forced: list | None = None, causal: bool = True, layers: int | None = None, kv_norm: bool = True,
                  interleaved: bool = True, **moe_control) -> list[torch.Tensor]:
    """Blocks of ``(ids, mask)`` [B, T] -> each block's [B, D] unit vectors,
    layer by layer over all blocks (one layer's weights upcast at a time).
    The experts see the blocks' real tokens only, all blocks at once.
    ``routes`` (a list) gets, per MoE layer, this pass's own picks of every
    real token [n, k] (block by block, row-major, each row's experts
    sorted); ``forced``, per MoE layer, the picks to apply instead (in that
    order; a layer past its end takes this pass's own). ``prod``,
    ``causal=False``, ``layers`` (the first ``layers`` only),
    ``kv_norm=False``, ``interleaved=False`` and ``moe_control`` (``moe``'s)
    are the controls'."""
    w = widths(hf)
    prod = prod or Products()
    dev = blocks[0][0].device
    states, masks, tables, biases = [], [], [], []
    for ids, mask in blocks:
        t = ids.shape[1]
        states.append(p["embed_tokens.weight"][ids.long()].float())
        masks.append(mask.bool())
        tables.append(rotary(t, w["rope"], w["theta"], dev))
        keep = mask[:, None, None, :].bool()
        if causal:
            keep = keep & torch.ones(t, t, dtype=torch.bool, device=dev).tril()
        biases.append(torch.zeros(keep.shape, device=dev).masked_fill(~keep, torch.finfo(torch.float32).min))
    for layer in range(w["layers"] if layers is None else layers):
        lw = _layer(p, layer)
        for j, x in enumerate(states):
            y = rms_norm(x, lw["input_layernorm.weight"], w["eps"])
            states[j] = x + attention(lw, w, y, *tables[j], biases[j], prod, kv_norm, interleaved)
        normed = [rms_norm(x, lw["post_attention_layernorm.weight"], w["eps"]) for x in states]
        if layer < w["dense"]:
            for j, y in enumerate(normed):
                states[j] = states[j] + swiglu(y, lw["mlp.gate_proj.weight"], lw["mlp.up_proj.weight"],
                                               lw["mlp.down_proj.weight"], prod)
            continue
        real = torch.cat([y[m] for y, m in zip(normed, masks)])
        step = layer - w["dense"]
        force = forced[step] if forced is not None and step < len(forced) else None
        out, picked = moe(lw, w, real, prod, force, **moe_control)
        if routes is not None:
            routes.append(picked)
        start = 0
        for j, m in enumerate(masks):
            n = int(m.sum())
            add = torch.zeros_like(states[j])
            add[m] = out[start : start + n]
            states[j] = states[j] + add
            start += n
        del lw
    out = []
    for x, m in zip(states, masks):
        x = rms_norm(x, p["norm.weight"].float(), w["eps"])
        last = (m.sum(1) - 1).clamp_min(0)
        pooled = x[torch.arange(x.shape[0], device=dev), last]
        out.append(pooled / torch.sqrt((pooled * pooled).sum(-1, keepdim=True) + 1e-12))
    return out


def encode(p: dict, hf: dict, ids: torch.Tensor, mask: torch.Tensor, **control) -> torch.Tensor:
    """One block of [B, T] ids and mask -> [B, D] unit vectors
    (``encode_blocks``)."""
    return encode_blocks(p, hf, [(ids, mask)], **control)[0]


def forward_flops(hf: dict, lens) -> float:
    """Model FLOPs of the encoder over rows of ``lens`` real tokens: per
    token twice the parameters it is multiplied by (the attention's
    projections in every layer; the dense MLP, or the router, the top-k
    experts and the shared experts), per row the attention's two products
    over its own length in every layer. Padding is not counted."""
    w = widths(hf)
    d, h = w["d"], w["heads"]
    tokens = float(sum(int(x) for x in lens))
    squares = float(sum(int(x) ** 2 for x in lens))
    attn = d * h * (w["nope"] + w["rope"]) + d * (w["rank"] + w["rope"]) + w["rank"] * h * (w["nope"] + w["vd"])
    attn += h * w["vd"] * d
    dense = 3 * d * w["ffn"]
    sparse = d * w["experts"] + 3 * d * w["moe_ffn"] * w["top_k"] + 3 * d * w["shared"]
    per_token = 2.0 * (w["layers"] * attn + w["dense"] * dense + (w["layers"] - w["dense"]) * sparse)
    return tokens * per_token + squares * 2.0 * h * (w["nope"] + w["rope"] + w["vd"]) * w["layers"]
