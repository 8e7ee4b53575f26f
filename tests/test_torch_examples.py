"""The port's ``examples`` and ``utils/profiling`` on the CPU: each example
runs (the same printed lines as the JAX package's but for numbers), the
stage timer counts and sums its stages, and ``trace`` writes a Chrome
trace."""

import json
import time

import pytest
import torch

from underwater_image_enhancement_tpu import examples as jex
from underwater_image_enhancement_tpu_torch import examples
from underwater_image_enhancement_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.mark.parametrize("k", range(1, 8))
def test_example_runs_on_cpu(k, capsys):
    examples.main(str(k), device="cpu")
    out = capsys.readouterr().out.splitlines()
    fn = examples.EXAMPLES[k - 1]
    assert out[0] == f"--- {fn.__name__} ---"
    assert fn.__name__ == jex.EXAMPLES[k - 1].__name__
    assert len(out) > 1 and not any("nan" in ln for ln in out)
    if k == 2:
        assert [ln.split()[0] for ln in out[1:]] == [
            "strong_dehazing", "medium_dehazing", "clahe_enhancement",
            "light_enhancement", "histogram_equalization"]
    if k == 4:
        assert out[1].startswith("feature dim 79,") and "finite: True" in out[1]
    if k == 5:
        assert sum(ln.endswith("<- best") for ln in out[1:]) == 1
    if k == 7:
        assert out[-1] == "Phase-1 data mesh on cpu: None"


def test_example_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        examples.example_1_single_strategy()


def test_stage_timer_sums_stages():
    t = profiling.StageTimer()
    for _ in range(3):
        with t.stage("a", sync_on=torch.zeros(1)):
            time.sleep(0.002)
    with t.stage("b"):
        pass
    assert t.counts == {"a": 3, "b": 1}
    assert t.totals["a"] >= 0.006 and t.totals["b"] >= 0.0
    lines = t.summary().splitlines()
    assert lines[0].startswith("a ") and "x3" in lines[0]
    assert lines[1].startswith("b ")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
