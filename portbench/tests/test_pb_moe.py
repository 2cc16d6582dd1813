"""The sparse-expert cell (``mellum2.poison_top20``) driven end to end at a
tiny size on the CPU: a sound run is correct and reports the cell's
metrics, a served token altered underneath and a token routed off its
top experts come out not correct, the weights in float8 read higher; its three readers on a traced batch (the
device times set by hand: a CPU trace has none); and the window's pair
counts against the mask they count."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import run
from portbench.common import bounds, moe_bounds, trace
from portbench.drivers import poison_moe
from portbench.reference.llama_decoder import Seq, mask_for

CPU = torch.device("cpu")
SEED = 2 ** 32 + 4321
NAME = "mellum2.poison_top20"
READERS = ("moe_generate_mfu.poison", "moe_expert_roofline.poison",
           "window_prefill_attn_roofline.poison")


def small(bench):
    """The cell's configuration and traffic at a size the CPU holds: every
    width cut, one period of the layer pattern, the window shorter than
    the prompts; the traffic's shape kept."""
    _, cfg, tr = run.cell(bench, NAME)
    rope = {k: dict(v, original_max_position_embeddings=64)
            if k == "full_attention" else v
            for k, v in cfg["rope_parameters"].items()}
    cfg = dict(cfg, hidden_size=48, head_dim=16, num_hidden_layers=4,
               num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=96, moe_intermediate_size=24,
               num_experts=8, num_experts_per_tok=2, vocab_size=1024,
               layer_types=cfg["layer_types"][:4],
               mlp_layer_types=cfg["mlp_layer_types"][:4],
               sliding_window=48, rope_parameters=rope,
               torch_dtype="float32", corpus_docs=300)
    tr = dict(tr, passage_words=[20, 30], query_words=[4, 8],
              malicious_words=[10, 15], llm_batch=2, query_batch=4,
              max_new_tokens=4, queries=64, warmup_padded_lens=[256],
              top_k=4, check_requests=2, check_bm25_queries=8,
              max_malicious_docs=2)
    return cfg, tr


def _run(bench, **kw):
    cfg, tr = small(bench)
    # every request checked: how many batches the short window holds
    # moves with the machine's load
    tr = dict(tr, check_requests=10 ** 6)
    return run.run_cell(bench, NAME, SEED, 0.3, False, CPU, cfg=cfg, tr=tr,
                        **kw)


def test_sound_run_is_correct(bench):
    res = _run(bench)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}
    notes = res["notes"]
    assert notes["served_tokens_checked"] > 0
    # the program's routes read from its log, at every checked position
    for where in ("prefill", "decode"):
        assert notes[f"route_{where}_pairs"] > 0
        assert 0 <= notes[f"route_{where}_pairs_differ"] <= \
            notes[f"route_{where}_pairs"]
    assert res["checks"]["route_gap_mean"]["value"] < 1e-3


def test_a_misrouted_token_is_caught(bench, monkeypatch):
    """The program takes the experts ranked 2nd to (k+1)th: the forward
    given its routes agrees with it, the router's shortfall does not."""
    from sdag_tpu_torch.ops import moe
    real = moe.route

    def shifted(u, router, k, norm_topk=True):
        w, idx = real(u, router, k + 1, norm_topk)
        return w[:, 1:] / w[:, 1:].sum(-1, keepdim=True), idx[:, 1:]
    monkeypatch.setattr(moe, "route", shifted)
    res = _run(bench)
    assert not res["correct"]
    assert res["checks"]["route_gap_mean"]["value"] > \
        res["checks"]["route_gap_mean"]["limit"]


def test_an_altered_token_is_caught(bench, monkeypatch):
    from sdag_tpu_torch.sdag.generate import Generator
    real = Generator._generate

    def broken(self, *a, **k):
        out, lengths = real(self, *a, **k)
        out = out.clone()
        out[0, 1] = (out[0, 1] + 7) % self.cfg.vocab_size
        return out, lengths
    monkeypatch.setattr(Generator, "_generate", broken)
    assert not _run(bench)["correct"]


def test_fp8_weights_read_higher(bench):
    cfg, tr = small(bench)
    tr = dict(tr, check_requests=8)
    sound, ctl = (run.run_cell(bench, NAME, SEED, 0.3, False, CPU, cfg=cfg,
                               tr=tr, control=c)["checks"]
                  for c in ("", "fp8_weights"))
    assert ctl["served_gap_mean"]["value"] > \
        sound["served_gap_mean"]["value"]


def test_readers_on_a_traced_batch(bench):
    cfg, tr = small(bench)
    st = poison_moe.setup(cfg, tr, SEED, CPU)
    st["records"] = [poison_moe.run_batch(st)]
    st["window_s"] = 1.0
    before = {k: st["gen"].stats[k] for k in poison_moe.COUNTERS}
    with profile(activities=[ProfilerActivity.CPU]):
        st["segment_records"] = [poison_moe.run_batch(st)]
    st["segment_moe"] = {k: st["gen"].stats[k] - before[k]
                         for k in poison_moe.COUNTERS}
    st["segment"] = trace.Segment()
    st["segment"].kernel_s.update({"sdag_moe_gate_up": 0.01,
                                   "sdag_prefill_f32": 0.02})
    st["segment"].kernel_n.update({"sdag_moe_gate_up": 1,
                                   "sdag_prefill_f32": 1})
    poison_moe.layer_inputs(st)
    seg = st["segment_moe"]
    assert seg["moe_decode_expert_reads"] > 0
    assert seg["moe_prefill_rows"] > 0
    values = {m: run.reader(m)(st) for m in READERS}
    assert all(v is not None and v > 0 for v in values.values()), values
    # K8's bound from the counted reads, over the kernels' time
    rows = seg["decode_tokens"] * cfg["num_hidden_layers"]
    want = moe_bounds.k8_bound(cfg, rows, seg["moe_decode_expert_reads"])
    assert values["moe_expert_roofline.poison"] == \
        pytest.approx(100 * want[2] / 0.01)
    # nothing to read: no K8 kernel in the trace
    st["segment"] = trace.Segment()
    assert run.reader("moe_expert_roofline.poison")(st) is None
    assert run.reader("window_prefill_attn_roofline.poison")(st) is None


@pytest.mark.parametrize("window", [1, 7, 30, 500])
def test_window_pairs_count_the_mask(window):
    seq = Seq(list(range(90)), 90, 11, ((11, 30), (30, 52), (52, 80)))
    m = mask_for(seq, CPU)
    i = torch.arange(90)
    win = m & (i[:, None] - i[None, :] < window)
    assert moe_bounds.window_iso_pairs(90, 11, seq.doc_spans, window) == \
        int(win.sum())
    causal = torch.tril(torch.ones(90, 90, dtype=torch.bool)) & (
        i[:, None] - i[None, :] < window)
    assert moe_bounds.window_causal_pairs(90, window) == int(causal.sum())
    if window >= 90:
        assert moe_bounds.window_iso_pairs(90, 11, seq.doc_spans, window) \
            == bounds.iso_pairs(90, 11, seq.doc_spans)
