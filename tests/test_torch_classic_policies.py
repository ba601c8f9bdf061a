"""The classic adaptation engine, adapt(), against JAX adapt() on the CPU
in its other configurations: NONE (the eval-mode DONE step on every
frame), VS+ER with ovs_policy="priority_queue" (every novel frame diverts;
the heap admits by loss) and VS+ER with leftright_consistency. The data,
the comparison and its bands are tests/test_torch_classic_adapt.py's.
"""

import pytest

from test_torch_classic_adapt import _few_threads, check_adapt_against_jax, data  # noqa: F401

RUNS = {
    "NONE": ("NONE", {}),
    "VS+ER priority_queue": ("VS+ER", {"ovs_policy": "priority_queue"}),
    "VS+ER leftright": ("VS+ER", {"leftright_consistency": True}),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_adapt_policies_match_jax(run, data, tmp_path, monkeypatch):  # noqa: F811
    mode, extra = RUNS[run]
    check_adapt_against_jax(mode, extra, data, tmp_path, monkeypatch)
