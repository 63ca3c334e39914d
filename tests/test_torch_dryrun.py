"""The port's `dryrun_multichip` (`metal_flash_attention_tpu_torch.entry`)
against the JAX package's (`__graft_entry__.dryrun_multichip`).

- JAX's `dryrun_multichip(4)` on four of its virtual CPU devices, its
  printed lines captured, beside the port's three legs on 4 gloo ranks
  (one spawn, `tests/_torch_tp_workers.dryrun_body`) fed JAX's weights
  (`PRNGKey(0)` the Llama, `(1)` the MoE, `(2)` the pipeline's layers,
  `(3)` its input) through `utils.params.params_from_numpy`: the mesh
  lines (dp=1 tp=2 cp=2, ep 2, 4 stages) equal verbatim; the bf16 legs'
  losses within MIXED_TOL and the float32 pipeline's within FP32_TOL of
  JAX's printed ones, plus their print rounding; the pipeline leg's own
  check against the chain (JAX's rtol / atol) passes on every rank.
- The port's `dryrun_multichip(1, device="cpu")` in this process (a
  one-rank gloo group it starts and ends itself) with its own seeded
  weights: JAX's three lines for n = 1.
"""

import concurrent.futures
import contextlib
import io
import re

import jax
import numpy as np
import pytest

import __graft_entry__ as jentry
import _torch_tp_workers as w
from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import moe as jm
from metal_flash_attention_tpu_torch.entry import dryrun_multichip
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
)

WORLD = 4
# The JAX dry run prints the bf16 legs' losses to 4 decimals and the
# pipeline's to 6.
PRINTED = (5e-5, 5e-5, 5e-7)
TOLS = (MIXED_TOL.o, MIXED_TOL.o, FP32_TOL.o)


def _numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _split(line: str) -> tuple:
    """(the line before its first loss, the first loss)."""
    head, loss = re.match(r"(.*?)loss=(-?[\d.]+)", line).groups()
    return head, float(loss)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's printed lines and every rank's (text, losses); the spawn runs
    beside JAX's compiles."""
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 (virtual) JAX devices")
    payload = {
        "mesh": _numpy(jl.init_params(jax.random.PRNGKey(0),
                                      jl.LlamaConfig.tiny(
                                          n_layers=2, n_heads=4,
                                          n_kv_heads=2))),
        "ep": _numpy(jm.init_params(jax.random.PRNGKey(1),
                                    jm.MoEConfig.tiny(n_heads=4,
                                                      n_kv_heads=2,
                                                      n_experts=4))),
        "pp": _numpy(jl.init_params(
            jax.random.PRNGKey(2),
            jl.LlamaConfig.tiny(n_layers=WORLD, dtype=np.float32))[
                "layers"]),
        "pp_x": np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                             (4, 2, 64, 128)))}
    workdir = tmp_path_factory.mktemp("dryrun")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(w.spawn, w.dryrun_body, WORLD, str(workdir),
                            payload)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            jentry.dryrun_multichip(WORLD)
        return text.getvalue().splitlines(), ranks.result()


def test_dryrun_lines_and_losses_match_jax(runs):
    jax_lines, ranks = runs
    got = ranks[0]["stdout"].splitlines()
    assert len(got) == len(jax_lines) == 3, (got, jax_lines)
    assert all(r["stdout"] == "" for r in ranks[1:])
    exact = (ranks[0]["losses"]["mesh"], ranks[0]["losses"]["ep"],
             ranks[0]["losses"]["pp"][0])
    for line, jline, loss, tol, printed in zip(got, jax_lines, exact, TOLS,
                                               PRINTED):
        head, _ = _split(line)
        jhead, jloss = _split(jline)
        assert head == jhead
        assert abs(loss - jloss) <= tol + printed, (line, jline)
    assert got[0].startswith("dryrun_multichip(4): mesh dp=1 tp=2 cp=2,")
    assert got[1].startswith("  ep dryrun: mesh dp=2 ep=2,")
    assert got[2].startswith("  pp dryrun: 4 stages fwd+bwd,")
    assert got[2].endswith("(grads allclose)")


def test_dryrun_losses_agree_across_ranks(runs):
    """Every rank reports the same global losses; the pipeline's equals
    its chain's on each (the leg raises otherwise)."""
    _, ranks = runs
    first = ranks[0]["losses"]
    for r in ranks[1:]:
        assert r["losses"]["mesh"] == pytest.approx(first["mesh"], abs=0)
        assert r["losses"]["ep"] == pytest.approx(first["ep"], abs=0)
        assert r["losses"]["pp"][0] == pytest.approx(first["pp"][0],
                                                     abs=FP32_TOL.o)
    for r in ranks:
        loss, chain = r["losses"]["pp"]
        assert abs(loss - chain) <= 1e-4 * abs(chain) + 1e-6


def test_dryrun_multichip_one_rank_in_process(capsys):
    dryrun_multichip(1, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [_split(line)[0] for line in lines[:2]] == [
        "dryrun_multichip(1): mesh dp=1 tp=1 cp=1, ",
        "  ep dryrun: mesh dp=1 ep=1, "]
    head, loss = _split(lines[2])
    assert head == "  pp dryrun: 1 stages fwd+bwd, " and np.isfinite(loss)
    assert lines[2].endswith("(grads allclose)") and len(lines) == 3
