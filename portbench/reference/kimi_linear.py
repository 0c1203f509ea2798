"""Kimi-Linear-48B-A3B in plain float32 PyTorch: the news encoder of the
``kimilinear48b-latent2304`` configuration
(https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct, its
``config.json``; the layer equations of the Kimi Linear report,
arXiv:2510.26692).

Token embeddings; per layer a pre-norm (RMSNorm) token mixer and a pre-norm
feed-forward, each added to the residual stream; a final RMSNorm; the state
of each row's last real token; the L2 norm. The token mixer is, by
``linear_attn_config`` (1-indexed layer lists), Kimi Delta Attention or
multi-head latent attention without rotation:

- KDA, 32 heads of 128: q, k, v = SiLU(causal depthwise conv of width 4 of
  ``q_proj`` x, ...); q and k L2-normalised per head (``x / sqrt(sum x^2 +
  1e-6)``), q scaled by 128 ** -0.5; log alpha = -exp(``A_log``[h]) ·
  softplus(``f_b_proj`` ``f_a_proj`` x + ``dt_bias``) a channel; beta =
  sigmoid(``b_proj`` x) a head; the delta rule one token at a time, S_0 = 0,
  S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T,
  o_t = S_t^T q_t; o RMSNorm'd per head (``o_norm``, eps 1e-5) times
  sigmoid(``g_b_proj`` ``g_a_proj`` x); ``o_proj``.
- MLA (no q LoRA, ``mla_use_nope``): as Moonlight's (``reference/moonlight``)
  with the 64 rotary dims of q and of the shared key left unrotated;
  softmax scale 192 ** -0.5, causal.
- Feed-forward: the first layer a SwiGLU of 9,216; the others a mixture of
  256 SwiGLU experts of 1,024 (the sigmoid router, the 8 experts of the
  highest score + ``e_score_correction_bias``, weighted by their scores
  renormalised and scaled by 2.446) plus one shared expert of 1,024.

The held share: a device of a two-card expert-parallel deployment holds
experts ``first`` to ``first + count - 1`` of every MoE layer; the router
keeps its 256 outputs and its top 8, and only the held experts' part is
added (what the other card's experts would add is left out, here as in
the program).

Departures, each where this file and the program agree against the source:

- the weights are bfloat16 values (the configuration's precision), read
  here as float32, and random from the seed (no checkpoint is in the
  repository): ``A_log`` log U(1, 16), ``dt_bias`` N(0, 1), the selection
  bias N(0, 1) times ``BIAS_SCALE``;
- Kimi Linear has no embedding head: it pools at the last real token, as the
  port pools every causal decoder.

Rows are given as their real tokens alone, packed: no padding anywhere. The
recurrence runs over all rows at once, time step by time step, on the rows
still running (sorted by length, a prefix of them). Parameter names are the
port's ``NewsEncoder`` ``state_dict`` names (the experts stacked, the held
ones only). No import of the port, its kernels or JAX; every matrix product
goes through ``nvembed.Products`` (the controls round its operands); the
weights are upcast one layer at a time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference.common import round_mantissa
from portbench.reference.moonlight import BIAS_SCALE, deinterleave
from portbench.reference.nvembed import Products, rms_norm, rotary, rotate_half

L2_EPS = 1e-6
QUERY_BLOCK = 1024  # MLA queries a block of one row's attention


def widths(hf: dict) -> dict:
    """The sizes of a Kimi Linear ``config.json`` under short names (its
    ``num_experts``, the router's width, whole)."""
    lac = hf["linear_attn_config"]
    n = hf["num_hidden_layers"]
    kda = {int(i) - 1 for i in lac["kda_layers"]}
    return {
        "vocab": hf["vocab_size"], "d": hf["hidden_size"], "layers": n, "heads": hf["num_attention_heads"],
        "nope": hf["qk_nope_head_dim"], "rope": hf["qk_rope_head_dim"], "vd": hf["v_head_dim"],
        "rank": hf["kv_lora_rank"], "ffn": hf["intermediate_size"], "experts": hf["num_experts"],
        "top_k": hf["num_experts_per_token"], "moe_ffn": hf["moe_intermediate_size"],
        "shared": hf["num_shared_experts"] * hf["moe_intermediate_size"], "dense": hf["first_k_dense_replace"],
        "scaling": hf["routed_scaling_factor"], "eps": hf.get("rms_norm_eps", 1e-5), "theta": hf["rope_theta"],
        "kinds": ["kda" if i in kda else "mla" for i in range(n)], "kda_heads": lac["num_heads"],
        "kda_hd": lac["head_dim"], "conv": lac["short_conv_kernel_size"],
    }


def param_shapes(hf: dict, held: tuple[int, int] | None = None) -> dict[str, tuple[tuple[int, ...], str]]:
    """Name -> (shape, init kind) of every parameter, in the port's order,
    with ``held[1]`` experts a MoE layer (``None``: all)."""
    w = widths(hf)
    d, h, i = w["d"], w["heads"], w["moe_ffn"]
    e = w["experts"] if held is None else held[1]
    hk, hd = w["kda_heads"], w["kda_hd"]
    inner = hk * hd
    out = {"embed_tokens.weight": ((w["vocab"], d), "normal")}
    for layer in range(w["layers"]):
        p = f"layers.{layer}."
        out[p + "input_layernorm.weight"] = ((d,), "norm_weight")
        if w["kinds"][layer] == "kda":
            a = p + "self_attn."
            out.update({
                a + "A_log": ((hk,), "normal"),
                a + "dt_bias": ((inner,), "normal"),
                a + "q_proj.weight": ((inner, d), "linear"),
                a + "q_conv1d.weight": ((inner, 1, w["conv"]), "linear"),
                a + "k_proj.weight": ((inner, d), "linear"),
                a + "k_conv1d.weight": ((inner, 1, w["conv"]), "linear"),
                a + "v_proj.weight": ((inner, d), "linear"),
                a + "v_conv1d.weight": ((inner, 1, w["conv"]), "linear"),
                a + "f_a_proj.weight": ((hd, d), "linear"),
                a + "f_b_proj.weight": ((inner, hd), "linear"),
                a + "b_proj.weight": ((hk, d), "linear"),
                a + "g_a_proj.weight": ((hd, d), "linear"),
                a + "g_b_proj.weight": ((inner, hd), "linear"),
                a + "o_norm.weight": ((hd,), "norm_weight"),
                a + "o_proj.weight": ((d, inner), "linear"),
            })
        else:
            out.update({
                p + "self_attn.q_proj.weight": ((h * (w["nope"] + w["rope"]), d), "linear"),
                p + "self_attn.kv_a_proj_with_mqa.weight": ((w["rank"] + w["rope"], d), "linear"),
                p + "self_attn.kv_a_layernorm.weight": ((w["rank"],), "norm_weight"),
                p + "self_attn.kv_b_proj.weight": ((h * (w["nope"] + w["vd"]), w["rank"]), "linear"),
                p + "self_attn.o_proj.weight": ((d, h * w["vd"]), "linear"),
            })
        out[p + "post_attention_layernorm.weight"] = ((d,), "norm_weight")
        if layer < w["dense"]:
            out.update({
                p + "mlp.gate_proj.weight": ((w["ffn"], d), "linear"),
                p + "mlp.up_proj.weight": ((w["ffn"], d), "linear"),
                p + "mlp.down_proj.weight": ((d, w["ffn"]), "linear"),
            })
        else:
            out.update({
                p + "mlp.gate.weight": ((w["experts"], d), "linear"),
                p + "mlp.gate.e_score_correction_bias": ((w["experts"],), "normal"),
                p + "mlp.experts.gate_up_proj": ((e, 2 * i, d), "linear"),
                p + "mlp.experts.down_proj": ((e, d, i), "linear"),
                p + "mlp.shared_experts.gate_proj.weight": ((w["shared"], d), "linear"),
                p + "mlp.shared_experts.up_proj.weight": ((w["shared"], d), "linear"),
                p + "mlp.shared_experts.down_proj.weight": ((d, w["shared"]), "linear"),
            })
    out["norm.weight"] = ((d,), "norm_weight")
    return out


def draw(hf: dict, gen: torch.Generator, device, dtype=torch.bfloat16,
         held: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """Every parameter, one at a time (``weights.make_params``' rules), in
    ``dtype``; ``A_log`` log U(1, 16) and the selection biases N(0, 1) times
    ``BIAS_SCALE``."""
    out = {}
    for name, spec in param_shapes(hf, held).items():
        if name.endswith("A_log"):
            x = torch.empty(spec[0], device=device).uniform_(1.0, 16.0, generator=gen).log()
        else:
            x = weights.make_params({name: spec}, gen, device)[name]
        if name.endswith("e_score_correction_bias"):
            x = x * BIAS_SCALE
        out[name] = x.to(dtype)
    return out


def param_count(hf: dict, held: tuple[int, int] | None = None, embeddings: bool = True) -> int:
    """The parameters ``param_shapes`` lists (no LM head)."""
    n = sum(math.prod(s) for s, _ in param_shapes(hf, held).values())
    return n if embeddings else n - hf["vocab_size"] * hf["hidden_size"]


def unheld_experts(hf: dict, held: tuple[int, int], seed: int, device):
    """The experts a share leaves out, for the control that computes all of
    them: ``layer -> (ids, gate_up [E', 2I, D], down [E', D, I])`` float32,
    drawn per layer from ``seed`` (at bfloat16 values, as the held ones)."""
    w = widths(hf)
    ids = [e for e in range(w["experts"]) if not held[0] <= e < held[0] + held[1]]
    d, i = w["d"], w["moe_ffn"]

    def get(layer: int):
        gen = weights.device_generator(seed, 1000 + layer, device)
        shapes = {"gu": ((len(ids), 2 * i, d), "linear"), "dn": ((len(ids), d, i), "linear")}
        p = {k: v.to(torch.bfloat16).float() for k, v in weights.make_params(shapes, gen, device).items()}
        return torch.tensor(ids, device=device), p["gu"], p["dn"]

    return get


def _layer(p: dict, layer: int) -> dict:
    """Layer ``layer``'s weights as float32, under names without the prefix."""
    pre = f"layers.{layer}."
    return {k[len(pre):]: v.float() for k, v in p.items() if k.startswith(pre)}


class Rows:
    """Packed rows: their lengths, each token's row and position, and the
    time-major order in which the recurrence visits them (step t: the rows
    longer than t, longest first)."""

    def __init__(self, lens: list[int], device):
        self.lens = lens
        self.n = sum(lens)
        starts = [0]
        for n in lens[:-1]:
            starts.append(starts[-1] + n)
        self.starts = starts
        self.row = torch.repeat_interleave(torch.arange(len(lens), device=device), torch.tensor(lens, device=device))
        self.pos = torch.arange(self.n, device=device) - torch.tensor(starts, device=device)[self.row]
        by_len = sorted(range(len(lens)), key=lambda r: -lens[r])
        self.steps = []  # (offset in time-major order, rows running)
        order, off = [], 0
        for t in range(max(lens) if lens else 0):
            running = [r for r in by_len if lens[r] > t]
            order.extend(starts[r] + t for r in running)
            self.steps.append((off, len(running)))
            off += len(running)
        self.time_major = torch.tensor(order, dtype=torch.long, device=device)
        self.by_len = by_len
        self.last = torch.tensor([s + n - 1 for s, n in zip(starts, lens)], device=device)


def short_conv(x: torch.Tensor, weight: torch.Tensor, rows: Rows) -> torch.Tensor:
    """The causal depthwise conv of packed rows: x [N, C], weight [C, 1, K];
    out[t] = sum_s weight[:, 0, K - 1 - s] x[t - s], zero before a row's
    start."""
    k = weight.shape[-1]
    out = x * weight[:, 0, k - 1]
    for s in range(1, k):
        shifted = torch.zeros_like(x)
        shifted[s:] = x[:-s]
        shifted[rows.pos < s] = 0.0
        out = out + shifted * weight[:, 0, k - 1 - s]
    return out


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def delta_rule(q, k, v, log_alpha, beta, rows: Rows, prod: Products, reset: int | None = None) -> torch.Tensor:
    """The recurrence one token at a time over packed rows: q, k, v,
    log_alpha [N, H, d], beta [N, H] -> o [N, H, dv]; all rows at each step
    (the ones still running). ``reset``: the state set to 0 every ``reset``
    tokens (a control)."""
    h, dk, dv = q.shape[1], q.shape[2], v.shape[2]
    tm = rows.time_major
    q, k, v, a, b = q[tm], k[tm], v[tm], log_alpha[tm].exp(), beta[tm]
    o = torch.empty(rows.n, h, dv, device=q.device)
    s = torch.zeros(len(rows.lens), h, dk, dv, device=q.device)
    r = prod.bits
    for t, (off, n) in enumerate(rows.steps):
        if reset and t and t % reset == 0:
            s.zero_()
        sl = slice(off, off + n)
        st = s[:n]
        st.mul_(a[sl][..., None])
        kt = k[sl]
        ks = prod.matmul(kt[:, :, None, :], st)[:, :, 0]
        u = b[sl][..., None] * (v[sl] - ks)
        st.view(n * h, dk, dv).baddbmm_(round_mantissa(kt, r).reshape(n * h, dk, 1),
                                        round_mantissa(u, r).reshape(n * h, 1, dv))
        o[sl] = prod.matmul(q[sl][:, :, None, :], st)[:, :, 0]
    out = torch.empty_like(o)
    out[tm] = o
    return out


def kda_block(lw: dict, w: dict, x: torch.Tensor, rows: Rows, prod: Products, decay: str = "channel",
              beta_one: bool = False, l2: bool = True, conv: bool = True, gate: bool = True,
              reset: int | None = None) -> torch.Tensor:
    """Kimi Delta Attention over packed rows x [N, D] (normed). The
    controls: ``decay="head"`` one decay a head (the mean of its channels'),
    ``beta_one``, ``l2=False`` (q and k not normalised), ``conv=False``
    (SiLU of the projections alone), ``gate=False`` (the output not gated),
    ``reset`` (the state set to 0 every so many tokens)."""
    n = x.shape[0]
    h, hd = w["kda_heads"], w["kda_hd"]
    qkv = []
    for name in ("q", "k", "v"):
        y = prod.linear(x, lw[f"self_attn.{name}_proj.weight"])
        if conv:
            y = short_conv(y, lw[f"self_attn.{name}_conv1d.weight"], rows)
        qkv.append(F.silu(y).view(n, h, hd))
    q, k, v = qkv
    if l2:
        q, k = l2norm(q), l2norm(k)
    q = q * hd**-0.5
    f = prod.linear(prod.linear(x, lw["self_attn.f_a_proj.weight"]), lw["self_attn.f_b_proj.weight"])
    log_alpha = -lw["self_attn.A_log"].exp()[:, None] * F.softplus(f.view(n, h, hd) + lw["self_attn.dt_bias"].view(h, hd))
    if decay == "head":
        log_alpha = log_alpha.mean(-1, keepdim=True).expand(n, h, hd)
    beta = torch.sigmoid(prod.linear(x, lw["self_attn.b_proj.weight"]))
    if beta_one:
        beta = torch.ones_like(beta)
    o = delta_rule(q, k, v, log_alpha, beta, rows, prod, reset)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + w["eps"]) * lw["self_attn.o_norm.weight"]
    o = o.reshape(n, h * hd)
    if gate:
        g = prod.linear(prod.linear(x, lw["self_attn.g_a_proj.weight"]), lw["self_attn.g_b_proj.weight"])
        o = o * torch.sigmoid(g)
    return prod.linear(o, lw["self_attn.o_proj.weight"])


def mla_block(lw: dict, w: dict, x: torch.Tensor, rows: Rows, prod: Products, rotated: bool = False) -> torch.Tensor:
    """The latent attention without rotation over packed rows x [N, D]
    (normed), causal within each row, queries in blocks of
    ``QUERY_BLOCK``. ``rotated``: the 64 dims rotated as Moonlight's (the
    control)."""
    h, nope, rope, vd, rank = w["heads"], w["nope"], w["rope"], w["vd"], w["rank"]
    q = prod.linear(x, lw["self_attn.q_proj.weight"]).view(-1, h, nope + rope)
    latent, k_pe = prod.linear(x, lw["self_attn.kv_a_proj_with_mqa.weight"]).split([rank, rope], dim=-1)
    latent = rms_norm(latent, lw["self_attn.kv_a_layernorm.weight"], w["eps"])
    kv = prod.linear(latent, lw["self_attn.kv_b_proj.weight"]).view(-1, h, nope + vd)
    ctx = torch.empty(x.shape[0], h, vd, device=x.device)
    for start, n in zip(rows.starts, rows.lens):
        qr = q[start : start + n].transpose(0, 1)  # [H, n, nope + rope]
        kr = torch.cat([kv[start : start + n, :, :nope].transpose(0, 1),
                        k_pe[start : start + n][None].expand(h, n, rope)], dim=-1)
        vr = kv[start : start + n, :, nope:].transpose(0, 1)
        if rotated:
            cos, sin = rotary(n, rope, w["theta"], x.device)
            qp, kp = deinterleave(qr[..., nope:]), deinterleave(kr[..., nope:])
            qr = torch.cat([qr[..., :nope], qp * cos + rotate_half(qp) * sin], dim=-1)
            kr = torch.cat([kr[..., :nope], kp * cos + rotate_half(kp) * sin], dim=-1)
        for q0 in range(0, n, QUERY_BLOCK):
            q1 = min(n, q0 + QUERY_BLOCK)
            logits = prod.matmul(qr[:, q0:q1], kr[:, :q1].transpose(-1, -2)) * (nope + rope) ** -0.5
            later = torch.arange(q1, device=x.device)[None, :] > torch.arange(q0, q1, device=x.device)[:, None]
            probs = torch.softmax(logits.masked_fill(later, float("-inf")), dim=-1)
            ctx[start + q0 : start + q1] = prod.matmul(probs, vr[:, :q1]).transpose(0, 1)
    return prod.linear(ctx.reshape(x.shape[0], h * vd), lw["self_attn.o_proj.weight"])


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, prod: Products) -> torch.Tensor:
    return prod.linear(F.silu(prod.linear(x, gate)) * prod.linear(x, up), down)


def moe(lw: dict, w: dict, x: torch.Tensor, prod: Products, held: tuple[int, int], forced: torch.Tensor | None = None,
        extra=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixture of experts over [N, D] tokens (normed): the held experts'
    part and the shared expert, and the experts each token picks by its own
    scores [N, k], sorted. With ``forced`` [N, k] the experts applied are
    those (another pass's picks), weighted by this pass's own scores of
    them. ``extra`` ``(ids, gate_up, down)``: more experts computed beside
    the held ones (the control that computes all of them)."""
    k, i = w["top_k"], w["moe_ffn"]
    scores = torch.sigmoid(prod.linear(x, lw["mlp.gate.weight"]))
    own = torch.topk(scores + lw["mlp.gate.e_score_correction_bias"], k, dim=-1).indices
    picked = own if forced is None else forced
    weight = scores.gather(1, picked)
    weight = weight / (weight.sum(-1, keepdim=True) + 1e-20) * w["scaling"]
    y = torch.zeros_like(x)
    experts = [(held[0] + e, lw["mlp.experts.gate_up_proj"][e], lw["mlp.experts.down_proj"][e]) for e in range(held[1])]
    if extra is not None:
        ids, gate_up, down = extra
        experts += [(int(e), gate_up[j], down[j]) for j, e in enumerate(ids.tolist())]
    for e, gate_up, down in experts:
        rows, slot = torch.nonzero(picked == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        out = swiglu(x[rows], gate_up[:i], gate_up[i:], down, prod)
        y.index_add_(0, rows, out * weight[rows, slot, None])
    y = y + swiglu(x, lw["mlp.shared_experts.gate_proj.weight"], lw["mlp.shared_experts.up_proj.weight"],
                   lw["mlp.shared_experts.down_proj.weight"], prod)
    return y, own.sort(dim=-1).values


@torch.no_grad()
def encode_rows(p: dict, hf: dict, rows: list, held: tuple[int, int] | None = None, prod: Products | None = None,
                routes: list | None = None, forced: list | None = None, unheld=None, rotated: bool = False,
                **kda_control) -> torch.Tensor:
    """Rows of token ids (each a 1-D tensor of its real tokens) -> [R, D]
    unit vectors, layer by layer (one layer's weights upcast at a time).
    ``held`` the experts held (``None``: all); ``routes`` (a list) gets, per
    MoE layer, this pass's own picks of every token [N, k] (row by row,
    position by position, each row's experts sorted); ``forced``, per MoE
    layer, the picks to apply instead. ``prod``, ``unheld`` (the experts the
    share leaves out, ``unheld_experts``: computed too), ``rotated`` and
    ``kda_control`` (``kda_block``'s) are the controls'."""
    w = widths(hf)
    held = (0, w["experts"]) if held is None else tuple(held)
    prod = prod or Products()
    dev = rows[0].device
    packed = Rows([int(r.numel()) for r in rows], dev)
    x = p["embed_tokens.weight"][torch.cat(rows).long()].float()
    for layer in range(w["layers"]):
        lw = _layer(p, layer)
        y = rms_norm(x, lw["input_layernorm.weight"], w["eps"])
        if w["kinds"][layer] == "kda":
            x = x + kda_block(lw, w, y, packed, prod, **kda_control)
        else:
            x = x + mla_block(lw, w, y, packed, prod, rotated)
        y = rms_norm(x, lw["post_attention_layernorm.weight"], w["eps"])
        if layer < w["dense"]:
            x = x + swiglu(y, lw["mlp.gate_proj.weight"], lw["mlp.up_proj.weight"], lw["mlp.down_proj.weight"], prod)
        else:
            step = layer - w["dense"]
            force = forced[step] if forced is not None and step < len(forced) else None
            extra = None if unheld is None else unheld(layer)
            out, picked = moe(lw, w, y, prod, held, force, extra)
            if routes is not None:
                routes.append(picked)
            x = x + out
        del lw
    x = rms_norm(x, p["norm.weight"].float(), w["eps"])
    pooled = x[packed.last]
    return pooled / torch.sqrt((pooled * pooled).sum(-1, keepdim=True) + 1e-12)


def forward_flops(hf: dict, lens, held_pairs: float) -> float:
    """Model FLOPs of the encoder over rows of ``lens`` real tokens, with
    ``held_pairs`` token-expert pairs of held experts over all MoE layers
    (the program's counter ``moe.assignments_held``): per token twice the
    parameters it is multiplied by in the projections of every layer, the
    dense MLP or the router and the shared expert; per held pair the
    expert's three products; per token of a KDA layer the recurrence in its
    chunk-64 form (``portbench/kda.py``); per row MLA's two products over its
    own length in every MLA layer. Padding is not counted."""
    from portbench.kda import recurrence_macs

    w = widths(hf)
    d, h, hk, hd = w["d"], w["heads"], w["kda_heads"], w["kda_hd"]
    inner = hk * hd
    tokens = float(sum(int(x) for x in lens))
    squares = float(sum(int(x) ** 2 for x in lens))
    n_kda = w["kinds"].count("kda")
    n_mla = w["layers"] - n_kda
    kda = 4 * d * inner + 2 * d * hd + 2 * hd * inner + d * hk + 3 * inner * w["conv"] + recurrence_macs(hk, hd, hd)
    mla = d * h * (w["nope"] + w["rope"]) + d * (w["rank"] + w["rope"]) + w["rank"] * h * (w["nope"] + w["vd"])
    mla += h * w["vd"] * d
    dense = 3 * d * w["ffn"]
    sparse = d * w["experts"] + 3 * d * w["shared"]
    per_token = 2.0 * (n_kda * kda + n_mla * mla + w["dense"] * dense + (w["layers"] - w["dense"]) * sparse)
    experts = 2.0 * 3 * d * w["moe_ffn"] * held_pairs
    return tokens * per_token + experts + squares * 2.0 * h * (w["nope"] + w["rope"] + w["vd"]) * n_mla
