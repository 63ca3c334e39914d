"""The port's `utils/profiling.py` against the JAX package's.

- `RooflineReport.__str__` gives JAX's text for the same fields.
- `attention_roofline` on CPU tensors reads the cpu row of the port's
  `DeviceContext`, as JAX's reads its cpu backend's: its GINSTRS and its
  utilization for the measured rate equal JAX's for several (n, d,
  causal, backward).
- `time_scalar_fn` gives a positive time for a CPU function; `trace`
  writes a chrome trace under the test's directory.
- The JAX docs' profiling example (tests/test_docs_examples.py
  `test_performance_guide_profiling_api`) through the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.utils import profiling as jprof
from metal_flash_attention_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from metal_flash_attention_tpu_torch.utils import profiling as prof

CASES = [
    # n, d, causal, with_backward, heads, batch
    (128, 64, False, False, 2, 1),
    (1000, 32, True, False, 4, 2),
    (4096, 128, True, True, 32, 1),
    (333, 256, False, True, 8, 3),
]


@pytest.mark.parametrize("fields", [(1.5e-3, 12.5, 8333.3, 0.0167),
                                    (2.0e-6, 0.004, 2000.0, 1.25),
                                    (0.25, 1e4, 4e4, 0.08)])
def test_roofline_report_text_matches_jax(fields):
    assert str(prof.RooflineReport(*fields)) == \
        str(jprof.RooflineReport(*fields))


@pytest.mark.parametrize("n,d,causal,backward,heads,batch", CASES)
def test_attention_roofline_accounting_matches_jax(n, d, causal, backward,
                                                   heads, batch):
    """The work and the roofline at the cpu row, JAX's through its own
    `attention_roofline` on a trivial function."""
    kw = dict(n=n, d=d, heads=heads, batch=batch, with_backward=backward,
              causal=causal, iters=2, dispatch_floor=0.0)
    x = torch.zeros((8, 8))
    rep = prof.attention_roofline(lambda a: a.sum(), (x,), **kw)
    jrep = jprof.attention_roofline(lambda a: a.sum(), (jnp.zeros((8, 8)),),
                                    **kw)
    assert rep.ginstrs == pytest.approx(jrep.ginstrs, rel=1e-12)
    # The same rate gives the same share of the same row's roofline.
    jroof = jrep.ginstrs_per_s / jrep.utilization
    assert rep.ginstrs_per_s / rep.utilization == pytest.approx(jroof,
                                                                rel=1e-12)
    assert rep.seconds > 0 and rep.ginstrs_per_s > 0


def test_time_scalar_fn_and_dispatch_floor_on_the_cpu():
    a = torch.randn((64, 64))
    floor = prof.measure_dispatch_floor(repeats=3, device="cpu")
    secs = prof.time_scalar_fn(lambda x: (x @ x).sum(), (a,), iters=4,
                               repeats=2)
    assert floor > 0 and secs > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    with prof.trace(path) as p:
        torch.randn((32, 32)).matmul(torch.randn((32, 32))).sum()
    assert p == path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_performance_guide_profiling_api_through_the_port():
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 2, 128, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))

    def one(q, k, v):
        return flash_attention(q, k, v)[0, 0, :1, :1].float().sum()

    rep = prof.attention_roofline(one, (q, k, v), n=128, d=64, heads=2,
                                  iters=2)
    assert isinstance(rep, prof.RooflineReport)
    assert rep.ginstrs_per_s > 0 and "GINSTRS" in str(rep)
