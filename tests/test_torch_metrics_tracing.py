"""The assertions of tests/test_metrics.py and tests/test_tracing.py, run
against the port's copies ``repro_torch.core.metrics`` and
``repro_torch.core.tracing`` (``port_tests``): thread-safe counters and
histograms, the reservoir bound, span conservation, deterministic head
sampling, the Chrome export checker, the flight recorder, attribution.

Two tracing tests replay a trace through the gateway, which comes to the
port with queue 1 item 8 (the next slice); they are left out here, and
the platform's own spans (``pool_claim``, ``register``, ``restore``) are
held in tests/test_torch_platform.py."""
from port_tests import bind, port_tests

GATEWAY_TESTS = ("test_live_replay_phases_conserve_and_export_validates",
                 "test_gateway_slo_drop_fires_flight_dump")

bind(globals(), port_tests("test_metrics"))
bind(globals(), port_tests(
    "test_tracing", exclude=GATEWAY_TESTS,
    drop_lines=("from repro.gateway import ReplayConfig, replay_trace",)))


def test_port_copies_are_the_ones_tested():
    assert test_counter_hammer_loses_no_increments.__globals__[  # noqa: F821
        "Metrics"].__module__ == "repro_torch.core.metrics"
    assert test_sampling_edge_rates.__globals__[  # noqa: F821
        "Tracer"].__module__ == "repro_torch.core.tracing"
