"""The port's `serve_spec` runtime_perf family on the CPU, against JAX's.

Apart from ``test_torch_runtime_perf.py`` for its time: six pools of
16 requests of 96 tokens in chunks of 4 under the emulated 0.05 s chunk
dispatch. Held, as there: record names, key sets and the values quick
does not change equal to the JAX module's committed records, and the
correctness contract of JAX's floors (tests/test_runtime_perf.py): every
spec record's tokens equal the spec-off run's (``match_baseline``) and
carry an acceptance rate. No speed floor is asserted.
"""

import pytest

from ray_tpu_torch._private import runtime_perf
from test_torch_runtime_perf import assert_like_jax


@pytest.fixture(scope="module")
def spec():
    return runtime_perf.run_serve_spec_benchmarks(quick=True, device="cpu")


def test_spec_family_like_jax(spec):
    assert_like_jax("serve_spec", spec)
    assert all(r["n_requests"] == 16 and r["per_s"] > 0 for r in spec)


@pytest.mark.parametrize("i", [1, 2, 4, 5], ids=[
    "depth2-greedy", "depth4-greedy", "depth2-sampled", "depth4-sampled"])
def test_spec_matches_the_spec_off_tokens(spec, i):
    assert spec[i]["match_baseline"] is True, spec[i]
    assert spec[i]["acceptance_rate"] is not None, spec[i]


def test_spec_off_records_carry_no_acceptance(spec):
    for r in (spec[0], spec[3]):
        assert r["spec_depth"] == 0 and r["acceptance_rate"] is None
        assert "match_baseline" not in r
