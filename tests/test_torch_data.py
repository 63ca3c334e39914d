"""`utils.data` of the port against the JAX package's: shards
byte-identical to JAX's, `TokenLoader` batches equal to JAX's token for
token over several steps (two shards of different sizes and dtypes),
and a loader resumed by `from_state` continuing the stream."""

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.utils import data as jdata
from metal_flash_attention_tpu_torch.utils import data as tdata

BATCH, SEQ, STEPS = 3, 63, 5


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.int64])
def test_shards_are_byte_identical(tmp_path, dtype):
    tokens = np.random.default_rng(0).integers(0, 30000, 1000).astype(dtype)
    jdata.write_shard(str(tmp_path / "j.bin"), tokens)
    tdata.write_shard(str(tmp_path / "t.bin"), tokens)
    assert (tmp_path / "j.bin").read_bytes() == \
        (tmp_path / "t.bin").read_bytes()
    back = tdata.open_shard(str(tmp_path / "j.bin"))
    assert back.dtype == dtype and np.array_equal(back, tokens)


@pytest.fixture
def shards(tmp_path):
    rng = np.random.default_rng(1)
    paths = [str(tmp_path / "a.bin"), str(tmp_path / "b.bin")]
    tdata.write_shard(paths[0], rng.integers(0, 50000, 5000)
                      .astype(np.uint16))
    tdata.write_shard(paths[1], rng.integers(0, 128256, 800)
                      .astype(np.int32))
    return paths


def test_batches_match_jax(shards):
    jl = jdata.TokenLoader(shards, BATCH, SEQ, seed=3)
    tl = tdata.TokenLoader(shards, BATCH, SEQ, seed=3, device="cpu")
    for j, t in zip(jl.take(STEPS), tl.take(STEPS)):
        assert t.dtype == torch.int32 and t.shape == (BATCH, SEQ + 1)
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert tl.state() == jl.state() == (3, STEPS)


def test_from_state_resumes_the_stream(shards):
    whole = [t.numpy() for t in tdata.TokenLoader(
        shards, BATCH, SEQ, seed=5, device="cpu").take(STEPS)]
    first = tdata.TokenLoader(shards, BATCH, SEQ, seed=5, device="cpu")
    head = [t.numpy() for t in first.take(2)]
    resumed = tdata.TokenLoader.from_state(shards, BATCH, SEQ,
                                           first.state(), device="cpu")
    tail = [t.numpy() for t in resumed.take(STEPS - 2)]
    for got, want in zip(head + tail, whole):
        assert np.array_equal(got, want)
    jres = jdata.TokenLoader.from_state(shards, BATCH, SEQ, (5, 2))
    assert np.array_equal(np.asarray(next(iter(jres))), tail[0])


def test_loader_refusals(shards, tmp_path):
    # sharding= is taken since slice 20 (tests/test_torch_train_tp.py):
    # one that is not a NamedSharding is a TypeError.
    with pytest.raises(TypeError, match="NamedSharding"):
        tdata.TokenLoader(shards, BATCH, SEQ, device="cpu",
                          sharding=object())
    with pytest.raises(ValueError, match="seq_len"):
        tdata.TokenLoader(shards, BATCH, 900, device="cpu")
    (tmp_path / "x.bin").write_bytes(b"not a shard".ljust(64))
    with pytest.raises(ValueError, match="not a token shard"):
        tdata.open_shard(str(tmp_path / "x.bin"))
