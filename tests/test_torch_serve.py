"""The port's serving driver (``repro_torch.launch.serve``) against the JAX
package's, on the CPU: greedy ``generate`` on every decoder arch's smoke
config in f32 and bf16 (the JAX loop driving its own model, compiled with
``_zoo.REF_OPTIONS``), the CLI's record, ``--tuned`` and the device rule."""
import json

import numpy as np
import pytest
import torch

from _zoo import (DECODER_ARCHS, DTYPES, JittedModel, batches, pair,
                  tokens_agree)
from repro.launch import serve as jax_serve
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.caches import activate_caches
from repro_torch.models import build_model


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_greedy_generate_matches_jax_package(arch, dtype):
    jm, jp, tm = pair(arch, dtype)
    jb, tb = batches(tm.cfg, T=6)
    want = jax_serve.generate(JittedModel(jm), jp, jb, 5)
    rec = {}
    got = serve.generate(tm, tb, 5, record=rec)
    assert got.dtype == torch.int32
    tokens_agree(got, want, rec["logits"][:, :5], dtype)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b",
                                  "llava-next-34b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b"])
def test_generate_logits_match_teacher_forcing(arch):
    """Decode against teacher forcing in f32, the card smoke's first gate,
    within 1e-3 * max|ref| (``tests/test_models.py``'s tolerance for the
    attention archs); Mixtral's 12-token prompt and 6 new tokens cross its
    window of 8; xLSTM's and Jamba's recurrent decode against their
    chunkwise ``logits``."""
    _, _, tm = pair(arch, "float32")
    T, new = (12, 6) if arch == "mixtral-8x7b" else (6, 5)
    _, tb = batches(tm.cfg, T=T)
    rec = {}
    toks = serve.generate(tm, tb, new, record=rec)
    full = dict(tb, tokens=torch.cat([tb["tokens"], toks], dim=1))
    with torch.no_grad():
        ref = tm.logits(full)[:, -new - 1:]
    err = float((rec["logits"][:, :new + 1] - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max())
    np.testing.assert_array_equal(toks.numpy(),
                                  ref[:, :new].argmax(-1).numpy())


def test_sampling_follows_the_generator():
    _, _, tm = pair("qwen2-7b", "float32")
    _, tb = batches(tm.cfg)
    runs = [serve.generate(tm, tb, 4, greedy=False,
                           generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert all(int(t.max()) < tm.cfg.vocab_size for t in runs)


def record_of(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cli_prints_the_jax_packages_record_keys(capsys, tmp_path):
    jax_serve.main(["--arch", "qwen2-7b", "--smoke", "--gen", "3"])
    want = record_of(capsys.readouterr().out)
    path = tmp_path / "serve.json"
    toks = serve.main(["--arch", "qwen2-7b", "--smoke", "--gen", "3",
                       "--device", "cpu", "--json", str(path)])
    got = record_of(capsys.readouterr().out)
    assert list(got) == list(want)
    assert {k: got[k] for k in ("arch", "batch", "prompt_len", "generated",
                                "greedy", "tokens")} == \
        {k: want[k] for k in ("arch", "batch", "prompt_len", "generated",
                              "greedy", "tokens")}
    assert got["sample"] == toks[0, :8].tolist()
    assert json.loads(path.read_text())["rows"] == [got]


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b",
                                  "phi3.5-moe-42b-a6.6b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b"])
def test_cli_serves_every_family_on_the_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "5", "--gen", "3", "--device", "cpu",
                       "--seed", "3"])
    rec = record_of(capsys.readouterr().out)
    assert toks.shape == (2, 3) and rec["tokens"] == 6
    again = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                        "--prompt-len", "5", "--gen", "3", "--device", "cpu",
                        "--seed", "3"])
    assert torch.equal(toks, again)          # the seed fixes the run


def test_cli_without_a_card_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-7b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke_config("whisper-medium"))


def test_tuned_activates_the_ports_caches(tmp_path, capsys, monkeypatch):
    from repro_torch.compile import cache as compile_cache
    from repro_torch.search import cache as search_cache
    from repro_torch.search import model as search_model
    # the process defaults come back after the test
    for mod, name in ((search_cache, "_default_cache"),
                      (compile_cache, "_default_cache"),
                      (search_model, "_default_store")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    paths = [tmp_path / n for n in ("t.json", "c.json", "m.json")]
    serve.main(["--arch", "olmo-1b", "--smoke", "--gen", "2", "--device",
                "cpu", "--tuned", "--tuning-cache", str(paths[0]),
                "--compile-cache", str(paths[1]), "--tuning-model",
                str(paths[2])])
    out = capsys.readouterr().out
    assert f"[serve] tuning cache {paths[0]}: 0 entries" in out
    assert f"[serve] compile artifact cache {paths[1]}: 0 artifact(s)" in out
    assert f"[serve] model store {paths[2]}: 0 model(s)" in out
    assert search_cache.get_default_cache().path == str(paths[0])
    assert compile_cache.get_default_artifact_cache().path == str(paths[1])
    assert search_model.get_default_store().path == str(paths[2])
    cache, acache = activate_caches(str(tmp_path / "t2.json"),
                                    str(tmp_path / "c2.json"))
    assert len(cache) == 0 and len(acache) == 0
    assert search_cache.get_default_cache() is cache
