"""The port's counterpart of the JAX package's `__graft_entry__.entry()`.

`entry()` returns (fn, example_args): the forward step of the flagship
Llama-style model at its test scale (`LlamaConfig.tiny(n_layers=2)`,
bf16, seeded random weights) over a [2, 256] batch of token ids, on the
card unless the caller passes ``device="cpu"``.  ``fn(params, tokens)``
gives float32 logits [2, 256, vocab]; the parameters are a dict of
tensors, so weights made elsewhere (`utils.params.params_from_numpy` of
the JAX package's) drop in.
"""

from __future__ import annotations

import torch

from metal_flash_attention_tpu_torch.models import llama
from metal_flash_attention_tpu_torch.utils.device import resolve_device


def entry(device=None):
    """(fn, (params, tokens)): the 2-layer tiny Llama forward and its
    example arguments, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    cfg = llama.LlamaConfig.tiny(n_layers=2)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    tokens = torch.zeros((2, 256), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        logits, _ = llama.forward(params, tokens, cfg)
        return logits

    return fn, (params, tokens)
