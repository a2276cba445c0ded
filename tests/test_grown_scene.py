"""Golden gates on the committed GROWN-scene sidecar
(tests/data/grown_scene.json, produced by scripts/make_grown_scene.py).

The fitted_20k artifact (test_fitted_scene.py) proves distillation at
fixed capacity; this sidecar proves the other half of the 3DGS recipe
the reference's pretrained models were produced with (notes.md:1-16):
**adaptive density control growing a random init by an order of
magnitude**, quality-gated at held-out poses the optimizer never saw.

The run itself is hours of device time, so CI gates the recorded
trajectory (the recipe is deterministic: seed + full arg record are in
the sidecar; scripts/make_grown_scene.py reproduces it)."""

import json
import os

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
SIDE = os.path.join(DATA, "grown_scene.json")

pytestmark = pytest.mark.skipif(
    not os.path.exists(SIDE), reason="grown-scene sidecar not present")


@pytest.fixture(scope="module")
def side():
    with open(SIDE) as f:
        return json.load(f)


def test_growth_by_an_order_of_magnitude(side):
    recipe = side["recipe"]
    # n_live_final excludes dead pad splats (pruned-in-place between
    # densify events) — the honest growth number
    live = side["n_live_final"]
    assert live >= recipe["target_n"] >= 100_000
    assert live >= 10 * recipe["init_n"]


def test_growth_came_from_densification(side):
    """The capacity must be GROWN by the densifier, not provisioned at
    init: every densify event records clones+splits, and N increases
    across the log."""
    log = side["densify_log"]
    assert len(log) >= 3
    added = sum(d.get("cloned", 0) + d.get("split", 0) for d in log)
    grown = side["n_live_final"] - side["recipe"]["init_n"]
    assert added >= 0.5 * grown, (added, grown)
    ns = [g["n"] for g in side["growth"]]
    assert ns[-1] > ns[0]


def test_held_out_quality_gate(side):
    """>= 30 dB at poses the optimizer never rendered (ROADMAP Reach 7)."""
    assert side["held_out_mean_db"] >= 30.0
    assert all(p >= 27.0 for p in side["held_out_psnr_db"])


def test_loss_actually_converged(side):
    assert side["loss_last"] < side["loss_first"] * 0.2


def test_recipe_is_reproducible(side):
    """The sidecar must carry the full deterministic recipe."""
    r = side["recipe"]
    for key in ("seed", "init_n", "steps", "views", "h", "w", "lr",
                "densify_every", "grad_threshold"):
        assert key in r, key
    assert side["train_wallclock_s"] > 0
