"""HuggingFace checkpoint conversion: Llama, Llama-3.1, Qwen2, Mistral
and Gemma-2 weights into the port's parameter trees.

The port of the JAX package's `models/convert.py`.  It does not import
`transformers`: a config is any object with HF's field names
(``hidden_size``, ``num_hidden_layers``, ``rope_scaling``, ...), and the
weights are a state dict of torch tensors or numpy arrays, or anything
with ``state_dict()`` (a `LlamaForCausalLM`).

The conversion goes tensor by tensor onto the target device and casts
there: HF stores a projection ``[out, in]`` for ``y = x @ W.T``, the port
``[in, out]`` for ``y = x @ W``, so each projection is transposed once;
norm gains stay float32, as `utils.params` keeps them.  No float32 copy
of the whole model is ever held (at 8B that would be 32 GB).  HF's
split-half RoPE is `llama.apply_rope`'s, so no head column moves.
"""

from __future__ import annotations

import numpy as np
import torch

from metal_flash_attention_tpu_torch.models import llama
from metal_flash_attention_tpu_torch.utils.device import resolve_device


def config_from_hf_llama(hf_config, dtype: torch.dtype = torch.bfloat16
                         ) -> llama.LlamaConfig:
    """An HF Llama / Qwen2 / Mistral config -> `LlamaConfig`, with
    Llama-3.1's ``rope_type="llama3"`` scaling; any other
    ``rope_scaling`` raises `ValueError`.  Qwen2 switches its window on
    by ``use_sliding_window``."""
    kw = {}
    rs = getattr(hf_config, "rope_scaling", None)
    if rs:
        rtype = rs.get("rope_type", rs.get("type"))
        if rtype != "llama3":
            raise ValueError(f"unsupported rope_scaling: {rtype}")
        kw = dict(
            rope_scaling_factor=float(rs["factor"]),
            rope_low_freq_factor=float(rs["low_freq_factor"]),
            rope_high_freq_factor=float(rs["high_freq_factor"]),
            rope_original_max_position=int(
                rs["original_max_position_embeddings"]))
    window = getattr(hf_config, "sliding_window", None)
    if window is not None and not getattr(hf_config, "use_sliding_window",
                                          True):
        window = None
    return llama.LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=(hf_config.num_key_value_heads
                    or hf_config.num_attention_heads),
        hidden_dim=hf_config.intermediate_size,
        rope_theta=float(hf_config.rope_theta),
        norm_eps=float(hf_config.rms_norm_eps),
        sliding_window=None if window is None else int(window),
        dtype=dtype,
        **kw)


def config_from_hf_gemma2(hf_config, dtype: torch.dtype = torch.bfloat16):
    """An HF Gemma-2 config -> `GemmaConfig` (the sliding window on even
    layers, the two soft caps, ``query_pre_attn_scalar``)."""
    from metal_flash_attention_tpu_torch.models import gemma

    return gemma.GemmaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        head_dim=hf_config.head_dim,
        hidden_dim=hf_config.intermediate_size,
        rope_theta=float(hf_config.rope_theta),
        norm_eps=float(hf_config.rms_norm_eps),
        sliding_window=int(hf_config.sliding_window),
        attn_logit_softcap=hf_config.attn_logit_softcapping,
        final_logit_softcap=hf_config.final_logit_softcapping,
        query_pre_attn_scalar=float(hf_config.query_pre_attn_scalar),
        dtype=dtype)


class _Reader:
    """Reads one HF tensor at a time onto ``device``, cast there."""

    def __init__(self, model_or_state_dict, dtype, device):
        self.sd = (model_or_state_dict.state_dict()
                   if hasattr(model_or_state_dict, "state_dict")
                   else model_or_state_dict)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.prefix = ("model." if any(k.startswith("model.")
                                       for k in self.sd) else "")

    def __contains__(self, name: str) -> bool:
        return name in self.sd

    def _get(self, name: str, dtype) -> tuple:
        """(the source tensor, it on ``device`` in ``dtype``)."""
        t = self.sd[name]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.asarray(t))
        return t, t.detach().to(self.device).to(dtype)

    def _owned(self, name: str, dtype) -> torch.Tensor:
        # A leaf of its own, never the caller's tensor: the training
        # steps update leaves in place.
        src, out = self._get(name, dtype)
        return out.clone() if out.data_ptr() == src.data_ptr() else out

    def lin(self, name: str) -> torch.Tensor:
        """[out, in] -> [in, out] in the model dtype."""
        return self._get(name, self.dtype)[1].t().contiguous()

    def vec(self, name: str) -> torch.Tensor:
        return self._owned(name, self.dtype)

    def norm(self, name: str) -> torch.Tensor:
        return self._owned(name, torch.float32)

    def projections(self, lp: str) -> dict:
        return {
            "wq": self.lin(lp + "self_attn.q_proj.weight"),
            "wk": self.lin(lp + "self_attn.k_proj.weight"),
            "wv": self.lin(lp + "self_attn.v_proj.weight"),
            "wo": self.lin(lp + "self_attn.o_proj.weight"),
            "w_gate": self.lin(lp + "mlp.gate_proj.weight"),
            "w_up": self.lin(lp + "mlp.up_proj.weight"),
            "w_down": self.lin(lp + "mlp.down_proj.weight"),
        }


def params_from_hf_llama(model_or_state_dict, cfg: llama.LlamaConfig,
                         device=None) -> dict:
    """HF Llama-family weights -> the port's parameter dict, on the card
    unless ``device`` says otherwise.  Qwen2's q/k/v biases become
    ``bq`` / ``bk`` / ``bv``; without ``lm_head.weight`` (tied
    embeddings) the head is a copy of the embedding's transpose, as in
    the JAX package: the training steps update leaves in place, so the
    two must not share storage."""
    r = _Reader(model_or_state_dict, cfg.dtype, device)
    layers = []
    for i in range(cfg.n_layers):
        lp = f"{r.prefix}layers.{i}."
        layer = r.projections(lp)
        layer["attn_norm"] = r.norm(lp + "input_layernorm.weight")
        layer["mlp_norm"] = r.norm(lp + "post_attention_layernorm.weight")
        for bn, hn in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            key = lp + f"self_attn.{hn}.bias"
            if key in r:
                layer[bn] = r.vec(key)
        layers.append(layer)
    embed = r.vec(r.prefix + "embed_tokens.weight")
    lm_head = (r.lin("lm_head.weight") if "lm_head.weight" in r
               else embed.t().contiguous())
    return {"embed": embed, "layers": layers,
            "final_norm": r.norm(r.prefix + "norm.weight"),
            "lm_head": lm_head}


def params_from_hf_gemma2(model_or_state_dict, cfg, device=None) -> dict:
    """HF Gemma-2 weights -> the port's Gemma parameter dict (tied
    embeddings; four norms a layer, gains stored as w and applied as
    1 + w), on the card unless ``device`` says otherwise."""
    r = _Reader(model_or_state_dict, cfg.dtype, device)
    layers = []
    for i in range(cfg.n_layers):
        lp = f"{r.prefix}layers.{i}."
        layer = r.projections(lp)
        layer.update({
            "pre_attn_norm": r.norm(lp + "input_layernorm.weight"),
            "post_attn_norm": r.norm(lp + "post_attention_layernorm.weight"),
            "pre_mlp_norm": r.norm(lp + "pre_feedforward_layernorm.weight"),
            "post_mlp_norm": r.norm(
                lp + "post_feedforward_layernorm.weight"),
        })
        layers.append(layer)
    return {"embed": r.vec(r.prefix + "embed_tokens.weight"),
            "layers": layers,
            "final_norm": r.norm(r.prefix + "norm.weight")}
