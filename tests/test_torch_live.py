"""The port's live app against the JAX package's, on the CPU at float32.

The HTTP round trip of ``tests/test_api_end_to_end.py``'s live-app test,
against ``variantformer_tpu_torch.api.live.LiveExpressionApp`` over the
port's ``VCFProcessor(device="cpu")``: the page equal to the JAX app's, a
gene/tissue request, the same request served from the cache, an in-silico
edit inside a CRE (away from the donor's own SNP there) that changes the
values, and bad requests answered with HTTP 400/404. The values must be within 1e-4 of the JAX app's ``predict``
(``impl="xla"``, the same ``init_seq2gene`` weights through the weight
bridge), and the edited VCF the same bytes.
"""

import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from tests.test_api_end_to_end import fixture_env  # noqa: F401  (the genome fixture)
from tests.test_torch_sweeps import _vcf_processors
from tests.test_torch_vep_model import _jax_native_loaded, model  # noqa: F401  (fixtures)
from variantformer_tpu.api.live import LiveExpressionApp as JaxLiveExpressionApp
from variantformer_tpu_torch.api.live import LiveExpressionApp

TISSUES = ["tissue0", "tissue2"]


@pytest.fixture(scope="module")
def apps(fixture_env, model, tmp_path_factory):
    port, jax_proc = _vcf_processors(fixture_env, model)
    root = tmp_path_factory.mktemp("live")
    return (LiveExpressionApp(port, vcf_path=fixture_env["vcf"], workdir=str(root / "port")),
            JaxLiveExpressionApp(jax_proc, vcf_path=fixture_env["vcf"],
                                 workdir=str(root / "jax")))


def _edit(env, pos=335, zygosity="het"):
    ref = env["seq"][pos - 1]
    return {"chrom": "chr1", "pos": pos, "ref": ref,
            "alt": {"A": "G", "C": "T", "G": "A", "T": "C"}[ref], "zygosity": zygosity}


def _close(got: dict, want: dict):
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-4, atol=1e-4)


def test_page_equal_jax(apps):
    port, jax_app = apps
    assert port.page() == jax_app.page()
    assert port.genes == jax_app.genes and port.tissues == jax_app.tissues


def test_http_round_trip_matches_jax(apps, fixture_env):
    port, jax_app = apps
    srv = port.make_server(port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, p = srv.server_address
        url = f"http://{host}:{p}"

        def post(payload):
            req = urllib.request.Request(f"{url}/api/predict", data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                return json.loads(resp.read())

        page = urllib.request.urlopen(f"{url}/", timeout=30).read().decode()
        assert page == port.page()
        for needle in ("id='gene'", "id='edits'", "/api/predict", "data-uberon="):
            assert needle in page, needle

        base = post({"gene": "GENEPLUS.1", "tissues": TISSUES})
        assert set(base["values"]) == set(TISSUES)
        assert base["cached"] is False and base["seconds"] >= 0
        assert base["vcf"] == Path(fixture_env["vcf"]).name
        _close(base["values"], jax_app.predict("GENEPLUS.1", TISSUES, [])["values"])

        again = post({"gene": "GENEPLUS.1", "tissues": TISSUES})
        assert again["cached"] is True and again["values"] == base["values"]

        edit = _edit(fixture_env)
        edited = post({"gene": "GENEPLUS.1", "tissues": TISSUES, "edits": [edit]})
        assert edited["values"] != base["values"], "an edit inside a CRE must change the values"
        _close(edited["values"], jax_app.predict("GENEPLUS.1", TISSUES, [edit])["values"])
        assert edited["vcf"] == jax_app.predict("GENEPLUS.1", TISSUES, [edit])["vcf"]
        port_vcf = port.workdir / edited["vcf"]
        assert port_vcf.read_bytes() == (jax_app.workdir / edited["vcf"]).read_bytes()

        # every tissue of the vocabulary when the request names none
        full = post({"gene": "GENEMINUS.1"})
        assert list(full["values"]) == port.tissues
        _close(full["values"], jax_app.predict("GENEMINUS.1", jax_app.tissues, [])["values"])

        for payload, message in (({"gene": "NOPE.1"}, "unknown gene"),
                                 ({"gene": "GENEPLUS.1", "tissues": ["nope"]},
                                  "unknown tissues")):
            req = urllib.request.Request(f"{url}/api/predict",
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as info:
                urllib.request.urlopen(req, timeout=30)
            assert info.value.code == 400
            assert message in json.loads(info.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(f"{url}/nope", timeout=30)
        assert info.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
