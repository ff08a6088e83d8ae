"""Every model family's reduced decode and train step traced by the port's
dry run (``repro_torch.launch.dryrun.trace_step``) on fake tensors.

A fake trace sees what real tensors hide: a host read of a device value
(``.item()``, ``bool(t)``, indexing by a 0-d tensor) raises
``DataDependentOutputException`` under ``FakeTensorMode`` (the card pays
such a read as a wait), and an op without a fake kernel fails to trace.
Each family's reduced config (dense, SSM, hybrid, MoE, encoder-decoder,
VLM) traces its decode step and its train step on one device with no
world (``local=True``): among them Whisper's decode, which adds the
learned position embedding at a 0-d device position by ``index_select``,
and the Mamba scans' ``torch.library`` fake kernels. The MoE body's
expert-parallel path needs a world: it traces in a subprocess on the
production 16 x 16 fake world (a fake world owns its process's default
group), the reduced Qwen3-MoE with 16 experts (one a model rank) and a
global batch of 16 (one sequence a data rank).
"""
import json
import os
import subprocess
import sys

import pytest

from _torch_dist_worker import SRC
from repro_torch.configs import get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun

FAMILIES = {"dense": "yi-9b", "ssm": "falcon-mamba-7b",
            "hybrid": "recurrentgemma-2b", "moe": "qwen3-moe-235b-a22b",
            "encdec": "whisper-medium", "vlm": "llava-next-34b"}
# the kernel route each family's step must trace (its plain version on
# the fake CPU tensors)
ROUTES = {"decode": "decode_attention_plain", "train": "flash_attention_ref"}

WORLD_SCRIPT = r"""
import json
from repro_torch.configs import get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
cfg = get_reduced("qwen3-moe-235b-a22b").replace(n_experts=16)
out = {}
for kind in ("decode", "train"):
    rec = dryrun.trace_step("qwen3-moe-235b-a22b",
                            InputShape(kind, 32, 16, kind),
                            multi_pod=False, cfg_override=cfg)
    out[kind] = {"routes": rec["routes"], "flops": rec["flops"],
                 "collectives": rec["collectives"]}
print("RECORDS " + json.dumps(out))
"""


@pytest.mark.parametrize("kind", ["decode", "train"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_step_traces_on_fake_tensors(family, kind):
    arch = FAMILIES[family]
    cfg = get_reduced(arch)
    assert cfg.family == family
    rec = dryrun.trace_step(arch, InputShape(kind, 32, 2, kind),
                            multi_pod=False, local=True, cfg_override=cfg)
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["collectives"] == {}            # one device, no world
    kern = rec["routes"]["kernel"]
    assert ROUTES[kind] in kern, kern
    assert not any("_cuda" in k for k in kern)   # no card route
    if family == "ssm" and kind == "train":
        assert {"selective_scan_ref", "selective_scan_bwd_ref"} <= set(kern)


def test_moe_body_traces_on_the_fake_world():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", WORLD_SCRIPT],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("RECORDS ")]
    recs = json.loads(line[-1][len("RECORDS "):])
    for kind, body in (("decode", "moe_ffn_dist_decode"),
                       ("train", "moe_ffn_dist_seq")):
        rec = recs[kind]
        assert rec["flops"] > 0
        assert body in rec["routes"]["dist"], rec["routes"]
        assert ROUTES[kind] in rec["routes"]["kernel"]
        assert rec["collectives"]["all-to-all"]["gsize"] == 16
