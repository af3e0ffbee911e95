"""Roofline reports (utils/roofline.py): shares only against a known card's
published peaks, never an assumed peak for an unknown device."""

import pytest

from online_3d_reconstruction.utils.roofline import PEAKS, sgm_aggregation_model


@pytest.mark.parametrize("kind", sorted(PEAKS))
def test_known_card_reports_shares_of_its_peaks(kind):
    point = sgm_aggregation_model(384, 512, 64, 8, seconds=1e-3)
    rep = point.report(PEAKS[kind])
    gbps = point.bytes_accessed / 1e-3 / 1e9
    assert rep["pct_hbm_peak"] == pytest.approx(100 * gbps / PEAKS[kind]["hbm_gbps"])
    assert rep["binding_roof"] in ("hbm", "tensor_core_bf16", "fp32")
    assert rep["pct_of_binding_roof"] == max(
        rep["pct_hbm_peak"], rep["pct_tensor_core_bf16_peak"], rep["pct_fp32_peak"])


def test_unknown_device_gets_no_share():
    rep = sgm_aggregation_model(384, 512, 64, 8, seconds=1e-3).report(
        PEAKS.get("cpu"))
    assert rep["time_ms"] == pytest.approx(1.0)
    assert "binding_roof" not in rep
    assert not any(k.startswith("pct_") for k in rep)


@pytest.mark.parametrize("seconds", [float("nan"), 0.0, 1e-9])
def test_unresolvable_time_is_reported_invalid(seconds):
    """nan or zero (too fast to resolve), or faster than the card's roof."""
    rep = sgm_aggregation_model(384, 512, 64, 8, seconds=seconds).report(
        PEAKS["NVIDIA H100 80GB HBM3"])
    assert "invalid" in rep and "binding_roof" not in rep
