"""The port's command lines (``repro_torch.compile``, ``.verify``,
``.graph``, ``.serve`` and the ``repro-torch`` dispatcher,
``repro_torch.cli``) against the JAX package's, on the CPU.

Each CLI runs in process through its ``main(argv)``.  The two packages
compile against different default targets (``tpu_v5e(1)`` in JAX,
``gpu_sm(8)`` in the port), so each comparison pins both to one target at
a time: ``--target`` where the CLI has it, else both packages'
``compile_graph`` and ``search.tune.make_graph`` defaulting to the target.
Exit codes and JSON payloads must then be equal, modulo the toolchain
version in artifact keys (``|jax=...`` against ``|torch=...``).  The JAX
graph CLI's ``--validate`` of a transformer block cannot run on the
installed JAX (its reference needs ``jax.experimental.enable_x64``), so
the port's is held to ``interpret_graph`` and its own float64 reference.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.cli as jax_cli
import repro.compile.__main__ as jax_compile_cli
import repro.graph.__main__ as jax_graph_cli
import repro.serve.__main__ as jax_serve_cli
import repro.verify.cli as jax_verify_cli
import repro_torch.cli as port_cli
import repro_torch.compile.__main__ as port_compile_cli
import repro_torch.graph.__main__ as port_graph_cli
import repro_torch.serve.__main__ as port_serve_cli
import repro_torch.verify.cli as port_verify_cli
from _pinned import TARGETS, pin
from repro.compile.driver import clear_memo as jax_clear_memo
from repro_torch.compile.driver import clear_memo

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(params=list(TARGETS))
def pinned(request, monkeypatch):
    """Both packages compile against the target (``_pinned.pin``), from an
    empty memo."""
    pin(monkeypatch, request.param)
    clear_memo()
    jax_clear_memo()
    return request.param


def without_version(d):
    """A payload with the toolchain version cut from every artifact key."""
    if isinstance(d, dict):
        return {k: (v.rsplit("|", 1)[0] if k == "key" else without_version(v))
                for k, v in d.items()}
    if isinstance(d, list):
        return [without_version(v) for v in d]
    return d


def run_both(tmp_path, port_main, jax_main, argv) -> tuple:
    """(port rc, port payload, JAX rc, JAX payload) of one command line
    with ``--json``."""
    out = []
    for name, main in (("port", port_main), ("jax", jax_main)):
        path = tmp_path / f"{name}.json"
        rc = main([*argv, "--json", str(path)])
        out += [rc, without_version(json.loads(path.read_text()))]
    return tuple(out)


@pytest.mark.parametrize("target", list(TARGETS))
def test_compile_smoke_validate_equals_the_jax_packages(tmp_path, target):
    clear_memo()
    jax_clear_memo()
    rc, got, jax_rc, want = run_both(
        tmp_path, port_compile_cli.main, jax_compile_cli.main,
        ["--suite", "smoke", "--validate", "--target", target])
    assert rc == jax_rc == 0
    assert got == want
    assert got["target"] == target and got["failures"] == 0
    assert [r["oracle_exact"] for r in got["rows"]] == [True] * 3


def test_compile_defaults_to_the_ports_target(tmp_path, capsys):
    clear_memo()
    path = tmp_path / "c.json"
    assert port_compile_cli.main(["--kernel", "gemm", "--shape", "64x32x48",
                                  "--json", str(path)]) == 0
    rows = json.loads(path.read_text())["rows"]
    assert json.loads(path.read_text())["target"] == "gpu_sm"
    assert rows[0]["graph"].startswith("gpu_sm")
    assert rows[0]["lowering"]["kind"] == "pallas_gpu_gemm"
    assert "[ok]" in capsys.readouterr().out


def test_verify_suite_all_equals_the_jax_packages(tmp_path, pinned):
    rc, got, jax_rc, want = run_both(
        tmp_path, port_verify_cli.main, jax_verify_cli.main,
        ["--suite", "all"])
    assert rc == jax_rc == 0
    assert got == want
    assert len(got["rows"]) == 24 and got["failures"] == 0


def test_verify_mutate_equals_the_jax_packages(tmp_path, pinned):
    rc, got, jax_rc, want = run_both(
        tmp_path, port_verify_cli.main, jax_verify_cli.main,
        ["--suite", "serve", "--mutate"])
    assert rc == jax_rc == 0
    assert got == want
    caught = [r for r in got["rows"] if "mutation" in r]
    assert len(caught) == 44 and all(r["caught"] for r in caught)


def test_servesim_compare_verify_equals_the_jax_packages(tmp_path, pinned):
    rc, got, jax_rc, want = run_both(
        tmp_path, port_serve_cli.main, jax_serve_cli.main,
        ["--compare", "--verify"])
    assert rc == jax_rc == 0
    assert got == want
    assert set(got["runs"]) == {"online", "static"}
    assert got["failures"] == 0


def test_servesim_expect_cached_equals_the_jax_packages(tmp_path, pinned):
    """A warm restart against the same cache file compiles nothing fresh,
    in both packages, with the same warmup stats and traces."""
    for name, main in (("port", port_serve_cli.main),
                       ("jax", jax_serve_cli.main)):
        argv = ["--archs", "olmo-1b,qwen2-7b", "--scheduler", "frozen",
                "--cache", str(tmp_path / f"{name}-arts.json")]
        clear_memo()
        jax_clear_memo()
        assert main(argv) == 0
        clear_memo()
        jax_clear_memo()
        assert main([*argv, "--expect-cached", "--json",
                     str(tmp_path / f"{name}.json")]) == 0
    got, want = (json.loads((tmp_path / f"{n}.json").read_text())
                 for n in ("port", "jax"))
    assert got["warmup"]["fresh_compiles"] == 0
    assert got == want


@pytest.mark.parametrize("argv", [[], ["--no-fuse"], ["--gru", "--validate"]],
                         ids=["fused", "unfused", "gru-validate"])
def test_graph_payload_equals_the_jax_packages(tmp_path, pinned, argv):
    argv = [*argv, "--device", "cpu"] if "--validate" in argv else argv
    port_path, jax_path = tmp_path / "port.json", tmp_path / "jax.json"
    rc = port_graph_cli.main([*argv, "--json", str(port_path)])
    jax_rc = jax_graph_cli.main([a for a in argv if a not in ("--device",
                                                              "cpu")]
                                + ["--json", str(jax_path)])
    assert rc == jax_rc == 0
    assert json.loads(port_path.read_text()) \
        == json.loads(jax_path.read_text())


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-medium"])
def test_graph_validate_on_the_cpu_is_bit_exact(tmp_path, capsys, arch):
    path = tmp_path / "g.json"
    assert port_graph_cli.main(["--arch", arch, "--validate", "--device",
                                "cpu", "--json", str(path)]) == 0
    out = capsys.readouterr().out
    for check in ("executed-vs-interpreted", "interpreted-vs-reference",
                  "executed-vs-reference"):
        assert f"[ok] {check}: bit-exact=True" in out
    payload = json.loads(path.read_text())
    assert payload["validated"] is True and payload["failures"] == 0


def test_graph_validate_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_graph_cli.main(["--validate"])


def test_dispatcher_commands_are_the_jax_packages_but_bench():
    assert list(port_cli.COMMANDS) \
        == [c for c in jax_cli.COMMANDS if c != "bench"]
    for cmd, (module, _) in port_cli.COMMANDS.items():
        jax_module = jax_cli.COMMANDS[cmd][0]
        assert module == "repro_torch" + jax_module[len("repro"):]


@pytest.mark.parametrize("argv", [[], ["--help"], ["no-such-command"],
                                  ["bench"]])
def test_dispatcher_usage_exit_codes(argv, capsys):
    want = {(): 2, ("--help",): 0, ("no-such-command",): 2,
            ("bench",): 2}[tuple(argv)]
    assert port_cli.main(argv) == want
    usage = capsys.readouterr()
    assert "'bench', is not ported" in usage.out + usage.err
    if argv != ["bench"]:
        assert jax_cli.main(argv) == want


def test_dispatcher_runs_a_subcommand_in_process(capsys):
    argv = list(sys.argv)
    assert port_cli.main(["verify", "--rules"]) == 0
    assert sys.argv == argv
    assert "srv.kv-budget" in capsys.readouterr().out
    assert port_cli.main(["compile", "--kernel", "nope"]) == 2
    assert sys.argv == argv


def test_cli_modules_import_without_jax():
    mods = ["repro_torch.cli"] + [m for m, _ in port_cli.COMMANDS.values()] \
        + ["repro_torch.verify.__main__", "repro_torch.serve"]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(n for n in sys.modules\n"
            "    if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_console_script_is_declared():
    text = (ROOT / "pyproject.toml").read_text()
    assert 'repro-torch = "repro_torch.cli:main"' in text
