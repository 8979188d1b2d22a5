"""The plain reference against the port's plain path, at a reduced size
on the CPU in float32: dense GQA with qkv bias, prefix-KV and LoRA on q
and v; granite's dropless moe block; each row with its own domain's
adapters."""
import pytest
import torch

from portbench import run
from portbench.lib import weights
from portbench.reference import decoder
from portbench.tests import tiny


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_reference_matches_the_ports_plain_path(kind):
    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.models import model as M
    sz = tiny.DENSE if kind == "dense" else tiny.MOE
    reg = "qwen2-7b" if kind == "dense" else "granite-moe-1b-a400m"
    cfg = run.configure(get_config(reg), tiny._override(sz))
    run.agree(cfg, sz)
    dev = torch.device("cpu")
    backbone, adapters = weights.model(cfg, 2 ** 40 + 7, dev, 3)
    bank = AdapterBank.create({f"d{i}": a for i, a in enumerate(adapters)})
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, sz["vocab_size"], (3, 24), generator=g)
    ids = torch.tensor([2, 0, 1], dtype=torch.int32)
    with torch.no_grad():
        lg = M.forward({"backbone": backbone, "adapters": bank.stacked},
                       {"tokens": tokens}, cfg, mode="serve", remat=False,
                       adapter_ids=ids)["logits"]
        for b in range(3):
            ref = decoder.logits(backbone, adapters[int(ids[b])], sz,
                                 tokens[b], 0)
            torch.testing.assert_close(lg[b].float(), ref, rtol=1e-4,
                                       atol=1e-4)
            # every adapter term is live: another domain's adapters move it
            other = decoder.logits(backbone, adapters[(int(ids[b]) + 1) % 3],
                                   sz, tokens[b], 0)
            assert (other - ref).abs().max() > 1e-3


def test_fp8_control_departs():
    sz = tiny.DENSE
    from repro_torch.configs.base import get_config
    cfg = run.configure(get_config("qwen2-7b"), tiny._override(sz))
    backbone, adapters = weights.model(cfg, 3, torch.device("cpu"), 1)
    t = torch.randint(0, sz["vocab_size"], (16,))
    a = decoder.logits(backbone, adapters[0], sz, t, 0)
    b = decoder.logits(backbone, adapters[0], sz, t, 0, "fp8")
    assert 1e-3 < (a - b).abs().max() < 0.5 * a.abs().max()
