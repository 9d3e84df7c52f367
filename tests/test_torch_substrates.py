"""The reference's data, fault-tolerance and train-driver tests
(``tests/test_substrates.py``) against the port, through ``port_tests``,
and a checkpoint that crosses the two packages mid-training.

The driver drill runs on the CPU: the port trains on CUDA unless told
otherwise, so ``"--device", "cpu"`` is added to its arguments.
"""
import numpy as np
import torch

from port_tests import bind, port_tests
from repro_torch.ft.failures import elastic_remesh

bind(globals(), port_tests("test_substrates", include=(
    "test_data_deterministic_and_host_sharded",
    "test_prefetcher_order_and_resume",
    "test_failure_injector_fires_once",
    "test_heartbeat_straggler_detection",
    "test_train_driver_failure_recovery"),
    replace=(('"--ckpt-every", "5"]', '"--ckpt-every", "5", "--device", "cpu"]'),)))


def test_data_pipeline_is_the_references_bit_for_bit():
    from repro.data import pipeline as jpipe
    from repro_torch.data import pipeline as tpipe
    for kw in (dict(vocab_size=256, seq_len=32, batch_size=2),
               dict(vocab_size=151936, seq_len=128, batch_size=3, seed=7,
                    host_id=1, n_hosts=2)):
        for step in (0, 5):
            a = jpipe.make_batch(jpipe.DataConfig(**kw), step)
            b = tpipe.make_batch(tpipe.DataConfig(**kw), step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_elastic_remesh_places_host_leaves_on_the_device():
    out = elastic_remesh({"w": np.arange(4, dtype=np.float32),
                          "s": {"t": torch.ones(2)}}, "cpu")
    assert isinstance(out["w"], torch.Tensor) and out["w"].device.type == "cpu"
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4))
    assert torch.equal(out["s"]["t"], torch.ones(2))


def test_reference_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """The reference's driver trains reduced qwen for 6 steps and
    checkpoints at steps 0 and 5; the port's driver resumes from step 5 at
    step 6 (the same data step) and its losses at steps 6 and 7 match a
    reference run of 8 steps within the bf16 tolerance (the schedule is in
    warmup, so the two runs' lr do not depend on --steps)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    common = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "2", "--seq",
              "32", "--ckpt-every", "5"]
    jtrain.main(common + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    want = jtrain.main(common + ["--steps", "8", "--ckpt-dir",
                                 str(tmp_path / "b")])
    capsys.readouterr()
    got = ttrain.main(common + ["--steps", "8", "--ckpt-dir",
                                str(tmp_path / "a"), "--device", "cpu"])
    assert "[train] resumed from step 5" in capsys.readouterr().out
    assert len(got) == 2
    np.testing.assert_allclose(got, want[6:], rtol=5e-2, atol=5e-2)
