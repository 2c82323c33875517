"""The port's capability probes (``variantformer_tpu_torch.probes``) against
the JAX script's (``scripts/mosaic_capability_probe.py``) on the CPU.

The JAX probes run their Pallas kernels in interpret mode: ``pallas_call``
is wrapped to pass ``interpret=True`` and to keep each call's input and
output. On the CPU the port's wrappers take their plain versions; on the
card they launch ``csrc/probes.cu``, which ``chip_smoke.py`` holds against
the same plain versions. Tolerances: exact for ``48slice`` and
``3dreshape`` (f32, same products and the same sum order), one bf16 ulp
for ``48bf16mm`` (f32 sums of 48 products in another order, then rounded).
"""

import contextlib
import importlib.util
import io
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from variantformer_tpu_torch import probes
from variantformer_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parent.parent
PLAIN = {
    "48slice": kernels.probe_48slice_plain,
    "3dreshape": kernels.probe_3dreshape_plain,
    "48bf16mm": kernels.probe_48slice_bf16_matmul_plain,
}
LINE = re.compile(r"^(48slice|3dreshape|48bf16mm): OK \(max err [0-9.e+-]+\)$")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "mosaic_capability_probe", REPO / "scripts" / "mosaic_capability_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _interpreted(calls: list):
    """pallas_call in interpret mode, recording (inputs, output) per call."""
    original = pl.pallas_call

    def pallas_call(*args, **kwargs):
        kernel = original(*args, **{**kwargs, "interpret": True})

        def run(*inputs):
            out = kernel(*inputs)
            calls.append(([np.asarray(x) for x in inputs], np.asarray(out)))
            return out

        return run

    with mock.patch.object(pl, "pallas_call", pallas_call):
        yield


@pytest.fixture(scope="module")
def jax_probes():
    """name -> (result, Pallas input, Pallas output); and the script's lines."""
    script = _jax_script()
    runs = {}
    for name, fn in script.PROBES.items():
        calls = []
        with _interpreted(calls):
            result = fn()
        assert len(calls) == 1
        runs[name] = (result, *calls[0])
    stdout = io.StringIO()
    with _interpreted([]), contextlib.redirect_stdout(stdout):
        with mock.patch("sys.argv", ["mosaic_capability_probe.py"]):
            script.main()
    return runs, stdout.getvalue().splitlines()


def test_same_probes_as_the_jax_script(jax_probes):
    runs, _ = jax_probes
    assert list(probes.PROBES) == list(runs)


@pytest.mark.parametrize("name", list(PLAIN))
def test_port_input_is_the_jax_input(jax_probes, name):
    (_, (x_jax,), _) = jax_probes[0][name]
    dtype = torch.bfloat16 if x_jax.dtype.name == "bfloat16" else torch.float32
    x = probes.probe_input(x_jax.shape, dtype, "cpu")
    np.testing.assert_array_equal(x.float().numpy(), x_jax.astype(np.float32))


@pytest.mark.parametrize("name", list(PLAIN))
def test_plain_version_matches_pallas(jax_probes, name):
    (_, (x_jax,), out_jax) = jax_probes[0][name]
    x = torch.from_numpy(x_jax.astype(np.float32))
    if x_jax.dtype.name == "bfloat16":
        x = x.to(torch.bfloat16)
    got = PLAIN[name](x).float().numpy()
    want = out_jax.astype(np.float32)
    assert got.shape == want.shape
    if name == "48bf16mm":  # one bf16 ulp: |a - b| <= 2^-7 max(|a|, |b|)
        bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
        assert (np.abs(got - want) <= bound).all()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(PLAIN))
def test_probe_result_matches_the_jax_probe(jax_probes, name):
    (ok_jax, detail_jax), _, _ = jax_probes[0][name]
    ok, detail = probes.PROBES[name]("cpu")
    assert ok and ok_jax
    if name != "48bf16mm":  # same output, same error against numpy
        assert detail == detail_jax
    assert float(detail.split()[-1]) == pytest.approx(float(detail_jax.split()[-1]), abs=0.07)


def test_cli_prints_the_jax_scripts_lines(jax_probes, capsys):
    kernels.reset_launches()
    assert probes.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all(LINE.match(line) for line in lines), lines
    jax_lines = jax_probes[1]
    assert all(LINE.match(line) for line in jax_lines), jax_lines
    assert [line.split(":")[0] for line in lines] == [line.split(":")[0] for line in jax_lines]
    assert lines[:2] == jax_lines[:2]
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # plain versions on the CPU


def test_cli_runs_named_probes_only(capsys):
    assert probes.main(["3dreshape", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == ["3dreshape: OK (max err 0.0)"]


def test_cli_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        probes.main([])


def test_cli_exits_nonzero_on_a_wrong_or_failing_probe(monkeypatch, capsys):
    monkeypatch.setitem(probes.PROBES, "48slice", lambda device: (False, "max err 1.0"))

    def broken(device):
        raise ValueError("no kernel")

    monkeypatch.setitem(probes.PROBES, "3dreshape", broken)
    assert probes.main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "48slice: WRONG-RESULT (max err 1.0)"
    assert lines[1] == "3dreshape: FAIL (ValueError: no kernel)"
    assert LINE.match(lines[2])


def test_cli_rejects_an_unknown_probe():
    with pytest.raises(SystemExit):
        probes.main(["48slice", "nosuchprobe", "--device", "cpu"])
