"""`python -m cook_tpu_torch.tools.debug_smoke` against the reference's
`tools/debug_smoke.py`: the full-node rig and the mp fleet's rig GET the
same routes, and every one answers 200 with a JSON body on the port."""
import pathlib
import re
import sys

import torch

from cook_tpu_torch.tools import debug_smoke

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))

import debug_smoke as ref_debug_smoke  # noqa: E402

torch.set_num_threads(1)

LINE = re.compile(r"^debug_smoke(\[mp\])?: (.+): (200 OK|FAIL) \(")


def _routes(out):
    """{(rig, path): verdict} from a run's lines."""
    routes = {}
    for line in out.splitlines():
        m = LINE.match(line)
        if m:
            routes[(m.group(1) or "node", m.group(2))] = m.group(3)
    return routes


def test_same_routes_as_the_reference_and_every_one_200(capsys):
    assert ref_debug_smoke.main() == 0
    want = _routes(capsys.readouterr().out)
    assert debug_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = _routes(out)
    assert set(got) == set(want)
    assert set(got.values()) == {"200 OK"}
    assert out.rstrip().endswith("debug_smoke: all debug endpoints healthy")
    assert ("node", "/debug/device") in got
    assert ("[mp]", "/debug/frontend") in got
    assert len([r for r in got if r[0] == "node"]) >= 15


def test_the_rig_walks_every_debug_route_of_the_openapi_doc():
    api, incident_id = debug_smoke.build_rig("cpu")
    api.build_app()  # generates the OpenAPI doc, as the server's start
    paths = debug_smoke.smoke_paths(api, incident_id)
    assert paths[-1] == "/jobs/smoke-0/timeline"
    assert f"/debug/incidents/{incident_id}" in paths
    documented = {p for p, methods in api._openapi["paths"].items()
                  if "get" in methods and p.startswith("/debug")}
    assert len(paths) - 1 == len(documented)
    assert api.scheduler.device.type == "cpu"
