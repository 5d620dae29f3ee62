"""The port's data_pipeline and multislice_mesh examples against the JAX
package's, each pair run as two processes at once
(test_torch_examples_reference.run_pair).

data_pipeline prints the same lines (the filter's count, the groupby
table through pandas, the parquet round trip, the shards), numbers to
1e-5 relative. multislice_mesh: the JAX script runs on 8 virtual CPU
devices, the port's on 8 forked gloo ranks; the mesh has the same sizes
(the port's leaves its size-1 pipe, expert and seq axes off), both
reject the ("dcn", "tensor") spec for putting a tensor axis across
slices, and the data-parallel gradient over (dcn, data) from the same
numpy seed has the same norm to 1e-5 relative.
"""

import ast
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_examples_reference import (assert_same_values,  # noqa: E402
                                           run_pair)


def test_data_pipeline_prints_what_the_reference_prints():
    ref, port = run_pair("data_pipeline")
    assert any(line.startswith("parquet rows:") for line in ref), ref
    assert_same_values(ref, port)


def _value(lines, key):
    (line,) = [x for x in lines if x.startswith(key + ":")]
    return line[len(key) + 1:].strip()


def test_multislice_mesh_matches_the_reference():
    ref, port = run_pair("multislice_mesh")
    assert len(port) == len(ref) == 3, (ref, port)
    ref_mesh = ast.literal_eval(_value(ref, "mesh"))
    port_mesh = ast.literal_eval(_value(port, "mesh"))
    assert list(port_mesh) == [a for a in ref_mesh if not (
        a in ("pipe", "expert", "seq") and ref_mesh[a] == 1)]
    assert port_mesh == {a: ref_mesh[a] for a in port_mesh}
    for lines in (ref, port):
        rejected = _value(lines, "rejected")
        assert "['tensor']" in rejected and "'dcn'" in rejected, rejected
    norm = float(_value(port, "grad norm"))
    assert math.isclose(norm, float(_value(ref, "grad norm")), rel_tol=1e-5)
    assert norm > 0
