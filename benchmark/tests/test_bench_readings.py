"""What the existing cells read from the harness, pinned: each
configuration's forward FLOPs (the base of `mfu.*`) and a digest of its
seeded estimator and autoencoder weights on the CPU.  The literals were
recorded before the harness took LayerNorm and attention; a change to the
weight plan, the draw or the FLOP count of these models shows here."""

import hashlib
import json
from pathlib import Path

import pytest

from benchmark.flops import forward_flops
from benchmark.weights import ae_weights, estimator_weights

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SEED = 3000000123
AE = "ed4926b95b99206586cd8c2f95784e4fb1b2927ce9e8885bcd1a0f3369ed4bce"
PINNED = {
    "simplepose_r50": (10852761600.0, "352d6072658aafa779fbef259b07cb62"
                       "049fbd9310ed40b06df736ddff8f3164"),
    "hrnet_w32": (15290007552.0, "1a44e3a1dad9ce08c6bdab73f9a91b5e"
                  "448d5db3eb480bc225384c5edf52fdd0"),
    "fastpose_dcn_r50": (11999887360.0, "ea3265f936911dcfec4356e3ed9b1e27"
                         "0c1a9668b805b2f45783b6d893d69770"),
}


def digest(state):
    h = hashlib.sha256()
    for name in sorted(state):
        t = state[name].contiguous()
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_readings_of_each_configuration_are_pinned(name):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    flops, est = PINNED[name]
    assert forward_flops(cfg) == flops
    assert digest(estimator_weights(cfg, SEED, "cpu")) == est
    assert digest(ae_weights(cfg, SEED, "cpu")) == AE
