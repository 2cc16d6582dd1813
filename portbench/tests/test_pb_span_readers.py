"""The readers of the program's spans (``prompt_build_ms.poison``,
``gen_host_ms.poison``, ``decode_launch_ms.poison``) on one small batch of
each cell traced by a CPU profiler: positive values, blind to the spans of
other batches, None with no spans; and an untraced cell run records no
span at all.  The CPU trace has no device gaps, so the segment's
``cudaGraphLaunch`` idle is set by hand for ``decode_launch_ms``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import small
from portbench import run
from portbench.common import trace
from portbench.drivers import poison
from sdag_tpu_torch.utils.profiling import clear_spans, spans

CPU = torch.device("cpu")
SEED = 2 ** 33 + 77
READERS = ("prompt_build_ms.poison", "gen_host_ms.poison",
           "decode_launch_ms.poison")


@pytest.fixture(autouse=True)
def _fresh_spans():
    clear_spans()
    yield
    clear_spans()


def _traced_batch(st):
    with profile(activities=[ProfilerActivity.CPU]):
        return poison.run_batch(st)


@pytest.mark.parametrize("name", ["mistral7b.poison_top5",
                                  "mistral7b.poison_top20"])
def test_readers_read_the_segments_batches_only(bench, name):
    cfg, tr = small(bench, name)
    st = poison.setup(cfg, tr, SEED, CPU)
    assert spans() == []
    first = _traced_batch(st)
    st["segment_records"] = [first]
    st["segment"] = trace.Segment()
    st["segment"].gaps["cudaGraphLaunch"] = 0.012
    chunks = sum(s.name == "sdag.gen.decode.launch" for s in spans())
    values = {m: run.reader(m)(st) for m in READERS}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["decode_launch_ms.poison"] == pytest.approx(12.0 / chunks)
    # the Generator's calls less their prefill and decode
    calls = [s for s in spans() if s.name == "sdag.orch.llm_batch"]
    inner = [s for s in spans()
             if s.name in ("sdag.gen.prefill", "sdag.gen.decode")]
    assert values["gen_host_ms.poison"] == pytest.approx(1e-6 * (
        sum(s.end_ns - s.start_ns for s in calls)
        - sum(s.end_ns - s.start_ns for s in inner)))
    assert 0 < values["gen_host_ms.poison"] < 1e-6 * sum(
        s.end_ns - s.start_ns for s in calls)
    assert {s.batch for s in spans() if s.name.startswith("sdag.orch.")} \
        == {str(first["q0"])}

    second = _traced_batch(st)
    assert {m: run.reader(m)(st) for m in READERS} == values
    st["segment_records"] = [second]
    assert all(run.reader(m)(st) > 0 for m in READERS)
    st["segment_records"] = [first, second]
    both = run.reader("prompt_build_ms.poison")(st)
    st["segment_records"] = [first]
    one = run.reader("prompt_build_ms.poison")(st)
    assert both != one

    clear_spans()
    assert all(run.reader(m)(st) is None for m in READERS)


def test_untraced_cell_run_records_no_span(bench):
    cfg, tr = small(bench, "mistral7b.poison_top5")
    res = run.run_cell(bench, "mistral7b.poison_top5", SEED, 0.3, False, CPU,
                       cfg=cfg, tr=tr)
    assert res["correct"], res["checks"]
    assert spans() == []
