"""Test-tier configuration: fast unit tier by default, opt-in slow tier.

``pytest -q`` (the tier-1 invocation, scripts/run_tier1.sh) runs with an
implied ``-m "not slow"`` so the unit tier stays fast (~1–2 minutes on this
container; compile-bound micro-CNN engine tests dominate).  The slow tier (per-architecture smoke, FL integration loops,
Pallas kernel sweeps, launch-step plans) runs with::

    PYTHONPATH=src python -m pytest -q -m "slow or not slow"   # everything
    PYTHONPATH=src python -m pytest -q -m slow                 # slow only

Any explicit ``-m`` expression (including ``-m ""``? no — empty means unset)
overrides the default.  See ROADMAP.md §Test tiers.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute tests (arch smoke, FL integration, kernel sweeps);"
        " deselected by default — run with -m 'slow or not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's hand-written kernels); skips on"
        " a host without one")
    if not config.option.markexpr:
        config.option.markexpr = "not slow"
