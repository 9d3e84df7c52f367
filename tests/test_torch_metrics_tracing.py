"""The assertions of tests/test_metrics.py and tests/test_tracing.py, run
against the port's copies ``repro_torch.core.metrics``,
``repro_torch.core.tracing`` and ``repro_torch.gateway`` (``port_tests``):
thread-safe counters and histograms, the reservoir bound, span
conservation, deterministic head sampling, the Chrome export checker,
the flight recorder, attribution, and the two tests that replay a trace
through the gateway (phase conservation over a live replay, the SLO drop
that fires a flight dump). Their platform is pinned to the CPU: the port
runs on CUDA unless a device is given."""
from port_tests import bind, port_tests

bind(globals(), port_tests("test_metrics"))
bind(globals(), port_tests(
    "test_tracing",
    replace=(("PlatformParams(", 'PlatformParams(device="cpu", '),)))


def test_port_copies_are_the_ones_tested():
    assert test_counter_hammer_loses_no_increments.__globals__[  # noqa: F821
        "Metrics"].__module__ == "repro_torch.core.metrics"
    assert test_sampling_edge_rates.__globals__[  # noqa: F821
        "Tracer"].__module__ == "repro_torch.core.tracing"
    assert test_gateway_slo_drop_fires_flight_dump.__globals__[  # noqa: F821
        "replay_trace"].__module__ == "repro_torch.gateway.replay"
