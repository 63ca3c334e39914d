"""`utils.checkpoint` of the port against the JAX package's: the same
file format, so a file written by either restores in the other bit for
bit (parameters of `LlamaConfig.tiny` in bf16 with float32 norms, and a
LoRA adapter tree with its (A, B) pairs and its ``rank``); leaves of
every stored dtype round-trip bit for bit; the history is pruned and
`latest` finds the newest file; a missing leaf and a leaf of another
shape raise JAX's errors; and an AdamW run saved after step 2 and
resumed takes steps 3 and 4 exactly as the uninterrupted run does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import lora as jlora
from metal_flash_attention_tpu.utils import checkpoint as jckpt
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models import lora as tlora
from metal_flash_attention_tpu_torch.models import optim as toptim
from metal_flash_attention_tpu_torch.utils import checkpoint as tckpt
from metal_flash_attention_tpu_torch.utils.tree import flatten, leaf_paths


def _bits(x) -> np.ndarray:
    """A tensor's or array's raw bytes, as a flat uint8 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.view(torch.uint8).reshape(-1).numpy().copy() \
            if x.dim() else x.reshape(1).view(torch.uint8).numpy().copy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float8_e4m3fn,
                                   torch.float8_e5m2, torch.int32,
                                   torch.int64, torch.uint8, torch.bool])
def test_leaves_round_trip_bit_for_bit(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 7), generator=g) * 50
    x = (x > 0) if dtype == torch.bool else x.to(dtype)
    tree = {"w": x, "layers": [{"b": x[0].clone()}, (x[1].clone(),)],
            "step": 7}
    f = tckpt.save(str(tmp_path), tree)
    like = {"w": torch.zeros_like(x),
            "layers": [{"b": torch.zeros_like(x[0])},
                       (torch.zeros_like(x[1]),)], "step": 0}
    out = tckpt.restore(f, like)
    assert out["step"] == 7 and isinstance(out["step"], int)
    assert isinstance(out["layers"][1], tuple)
    for got, want in zip(flatten(out)[0], flatten(tree)[0]):
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype
            assert np.array_equal(_bits(got), _bits(want))
    # JAX reads the same leaves, with the same bits.
    jout = jckpt.restore(f, jax.tree.map(np.asarray, {
        "w": np.zeros(x.shape), "layers": [{"b": np.zeros(x[0].shape)},
                                           (np.zeros(x[1].shape),)],
        "step": 0}))
    if dtype == torch.int64:     # JAX without x64 holds it as int32
        assert np.array_equal(np.asarray(jout["w"]), x.numpy())
    else:
        assert np.array_equal(_bits(jout["w"]), _bits(x))


def test_history_is_pruned_and_latest_is_newest(tmp_path):
    tree = {"w": torch.ones(4)}
    assert tckpt.latest(str(tmp_path / "none")) is None
    for step in (1, 2, 5, 10, 12):
        tckpt.save(str(tmp_path), tree, step=step, keep=3)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["ckpt_00000005.npz", "ckpt_00000010.npz",
                     "ckpt_00000012.npz"]
    assert tckpt.latest(str(tmp_path)).endswith("ckpt_00000012.npz")
    assert jckpt.latest(str(tmp_path)) == tckpt.latest(str(tmp_path))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_missing_and_misshapen_leaves_raise_as_in_jax(tmp_path, writer):
    tree = {"a": np.ones((2, 3), np.float32), "b": np.zeros(4, np.int32)}
    f = (jckpt.save if writer == "jax" else tckpt.save)(str(tmp_path), tree)
    for restore, like in (
            (jckpt.restore, dict(tree, c=np.ones(1, np.float32))),
            (tckpt.restore, {"a": torch.ones((2, 3)),
                             "b": torch.zeros(4, dtype=torch.int32),
                             "c": torch.ones(1)})):
        with pytest.raises(KeyError, match="'c'"):
            restore(f, like)
    with pytest.raises(ValueError, match="'a'"):
        jckpt.restore(f, dict(tree, a=np.ones((3, 2), np.float32)))
    with pytest.raises(ValueError, match="'a'"):
        tckpt.restore(f, {"a": torch.ones((3, 2)),
                          "b": torch.zeros(4, dtype=torch.int32)})


def _trees(kind):
    """(JAX tree, a port tree of the same structure and shapes, other
    values) of ``kind``."""
    jcfg = jl.LlamaConfig.tiny(n_layers=2)
    tcfg = tl.LlamaConfig.tiny(n_layers=2)
    g = torch.Generator().manual_seed(4)
    if kind == "params":
        return (jl.init_params(jax.random.PRNGKey(3), jcfg),
                tl.init_params(tcfg, g, device="cpu"))
    return (jlora.init_lora_adapters(jax.random.PRNGKey(3), jcfg, 3, 4,
                                     b_scale=0.2),
            tlora.init_lora_adapters(tcfg, 3, 4, generator=g, b_scale=0.2,
                                     device="cpu"))


def _jax_bits(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): _bits(np.asarray(x))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", ["params", "lora"])
def test_jax_file_restores_in_the_port_bit_for_bit(tmp_path, kind):
    jtree, like = _trees(kind)
    f = jckpt.save(str(tmp_path), jtree, step=3)
    out = tckpt.restore(tckpt.latest(str(tmp_path)), like)
    assert out is not like and f == tckpt.latest(str(tmp_path))
    want = _jax_bits(jtree)
    leaves = flatten(out)[0]
    assert sorted(leaf_paths(out)) == sorted(want)
    for key, leaf in zip(leaf_paths(out), leaves):
        assert np.array_equal(_bits(leaf) if isinstance(leaf, torch.Tensor)
                              else _bits(np.int64(leaf)), want[key]), key
    if kind == "params":
        assert out["layers"][0]["wq"].dtype == torch.bfloat16
        assert out["layers"][0]["attn_norm"].dtype == torch.float32
    else:
        assert out["rank"] == 4 and isinstance(out["layers"][0]["wv"],
                                               tuple)


@pytest.mark.parametrize("kind", ["params", "lora"])
def test_port_file_restores_in_jax_bit_for_bit(tmp_path, kind):
    jlike, ttree = _trees(kind)
    tckpt.save(str(tmp_path), ttree, step=3)
    out = jckpt.restore(jckpt.latest(str(tmp_path)), jlike)
    got = _jax_bits(out)
    for key, leaf in zip(leaf_paths(ttree), flatten(ttree)[0]):
        if isinstance(leaf, torch.Tensor):
            assert np.array_equal(got[key], _bits(leaf)), key
        else:                    # the rank: int32 in JAX without x64
            assert int(out[key]) == leaf
    if kind == "params":
        assert out["layers"][0]["wq"].dtype == jnp.bfloat16
        assert out["layers"][0]["attn_norm"].dtype == jnp.float32


def _loss(params, batch):
    cfg = tl.LlamaConfig.tiny(n_layers=1, dtype=torch.float32)
    return tl.loss_fn(params, batch, cfg)


def test_adamw_run_resumes_exactly(tmp_path):
    """4 AdamW steps in one run, and 2, a save of the parameters, the
    optimizer state and a loader position, a restore into fresh
    structures, then 2 more: the losses and parameters of steps 3 and 4
    are bit-identical."""
    cfg = tl.LlamaConfig.tiny(n_layers=1, dtype=torch.float32)
    batches = [torch.from_numpy(np.random.default_rng(i).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)) for i in range(4)]

    def fresh():
        return tl.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    init_fn, step_fn = toptim.make_train_step(
        _loss, lambda ts: torch.optim.AdamW(ts, lr=1e-2))
    params = fresh()
    state = init_fn(params)
    losses = []
    for b in batches:
        params, state, loss = step_fn(params, state, b)
        losses.append(loss)

    p2 = fresh()
    s2 = init_fn(p2)
    for b in batches[:2]:
        p2, s2, _ = step_fn(p2, s2, b)
    tckpt.save(str(tmp_path), {"params": p2, "state": s2,
                               "loader": (0, 2)}, step=2)
    p3 = fresh()
    s3 = init_fn(p3)
    out = tckpt.restore(tckpt.latest(str(tmp_path)),
                        {"params": p3, "state": s3, "loader": (0, 0)})
    assert out["loader"] == (0, 2)
    assert out["state"]["opt"] is s3["opt"]
    assert float(s3["opt"].state_dict()["state"][0]["step"]) == 2
    p3, s3 = out["params"], out["state"]
    for i, b in enumerate(batches[2:], start=2):
        p3, s3, loss = step_fn(p3, s3, b)
        assert torch.equal(loss, losses[i]), i
    for got, want in zip(flatten(p3)[0], flatten(params)[0]):
        assert torch.equal(got, want)
    for got, want in zip(s3["shadow"], state["shadow"]):
        assert torch.equal(got, want)
