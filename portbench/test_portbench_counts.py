"""The frozen counts against numbers worked by hand."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench.counts import peaks, ssd_scan
from portbench.registry import Registry

HERE = Path(__file__).parent
MAMBA = json.loads((HERE / "configs/mamba2-780m.json").read_text())
model_flops = Registry().model_flops(MAMBA)       # counts/model_flops.ssm
# one Mamba2 layer of mamba2-780m: in_proj (z, xBC, dt), conv taps, out_proj
LAYER = 1536 * (2 * 3072 + 2 * 128 + 48) + 4 * 3328 + 3072 * 1536


def test_ssd_scan():
    # S 300 in chunks of 256 and 44 rows: 256*257/2 + 44*45/2 pairs
    nbytes, flops = ssd_scan.cost(1, 300, 2, 4, 8, 256)
    assert nbytes == (2 * 300 * 2 * 4 * 2 + 300 * 2 * 4 + 2 * 4
                      + 2 * 300 * 8 * 2 + 2 * 4 * 8 * 4)
    pairs = 32896 + 990
    assert flops == 2 * pairs * 8 + 2 * 2 * pairs * 4 + 4 * 2 * 300 * 8 * 4
    assert ssd_scan.cost(1, 300, 2, 4, 8, 256, groups=1) == (nbytes, flops)


def test_ssd_scan_groups():
    # S 100 in chunks of 64 and 36 rows; 4 heads of 8 in 2 B/C groups,
    # state 16, batch 3. Bytes: x and y 3*100*4*8 bf16 each, dt 3*100*4
    # fp32, A 4 fp32, B and C 3*100*2*16 bf16 each, the state 3*4*8*16
    # fp32: 38,400 + 4,800 + 16 + 38,400 + 6,144 = 87,760
    pairs = 64 * 65 // 2 + 36 * 37 // 2                  # 2,080 + 666
    assert pairs == 2746
    nbytes, flops = ssd_scan.cost(3, 100, 4, 8, 16, 64, groups=2)
    assert nbytes == 87760
    # C B^T a group: 2*3*2*2,746*16 = 527,232; its product with x a head:
    # 2*3*4*2,746*8 = 527,232; the state in and out: 4*3*4*100*16*8
    # = 614,400
    assert flops == 527232 + 527232 + 614400 == 1668864
    one = ssd_scan.cost(3, 100, 4, 8, 16, 64)
    assert nbytes - one[0] == 2 * 3 * 100 * 16 * 2       # one more B, C
    assert flops - one[1] == 2 * 3 * 2746 * 16           # one more C B^T


def test_peaks():
    assert peaks.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 989e12) == pytest.approx(1.0)


def test_model_flops():
    assert model_flops.applied_params(MAMBA) == 48 * LAYER
    assert model_flops.head_params(MAMBA) == 1536 * 50288
    d = model_flops.decode(MAMBA, 1000)
    assert d == 2.0 * (48 * LAYER + 1536 * 50288) + 4.0 * 48 * 64 * 128 * 48
    assert model_flops.decode(MAMBA, 4000) == d


@pytest.mark.parametrize("S", [100, 256, 2500])
def test_prefill_flops(S):
    # the scan's products in chunks of 256 (the last one short), 48 heads
    # of 64, state 128, in each of the 48 layers
    rows = [min(256, S - c) for c in range(0, S, 256)]
    pairs = sum(r * (r + 1) // 2 for r in rows)
    scan = 2.0 * pairs * 128 + 2.0 * 48 * pairs * 64 + 4.0 * 48 * S * 128 * 64
    assert model_flops.prefill(MAMBA, S) == pytest.approx(
        2.0 * 48 * LAYER * S + 2.0 * 1536 * 50288 + 48 * scan)
