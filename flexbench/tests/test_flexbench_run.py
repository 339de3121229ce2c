"""A whole run of each tiny cell on the CPU, past run.py's look for a card:
correct as it stands, and not correct with the timed path broken
underneath (a token altered where it is produced, a decode step that
leaves its cache unchanged, half of the batch left out)."""
import pytest

import flexbench_tiny as tiny

CELLS = ("mixtral-8x7b-l8.chat", "nemotron-4-340b-l4.docs")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    res = tiny.run(root, cell)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = {"ttft_p95_ms", "tpot_p95_ms", "output_tokens_per_s", "setup_s"}
    assert set(res["metrics"]) == e2e
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "compared"


def _altered_tokens(monkeypatch):
    from repro_torch.models.model import Model
    decode = Model.decode

    def wrong(self, params, tokens, cache, lengths):
        logits, cache = decode(self, params, tokens, cache, lengths)
        # every row's token becomes the next id after its argmax
        nxt = (logits.argmax(-1) + 1) % logits.shape[-1]
        logits = logits.clone()
        logits[range(logits.shape[0]), nxt] = logits.max(-1).values + 1.0
        return logits, cache

    monkeypatch.setattr(Model, "decode", wrong)


def _stale_cache(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "kv_write_decode",
                        lambda cache, k, v, lengths: cache)


def _half_batch(monkeypatch):
    from repro_torch.models.model import Model
    decode = Model.decode

    def half(self, params, tokens, cache, lengths):
        logits, cache = decode(self, params, tokens, cache, lengths)
        B = logits.shape[0]
        logits = logits.clone()
        logits[B // 2:] = logits[:B - B // 2]
        return logits, cache

    monkeypatch.setattr(Model, "decode", half)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered_tokens, _stale_cache,
                                   _half_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_batch"])
def test_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = tiny.run(root, cell)
    assert not res["correct"], res["compared"]
