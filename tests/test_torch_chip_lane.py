"""chip_smoke.py's lane, on the CPU: phases LANE_PHASES run in a process of
their own beside phases of the main process, every phase of the module
docstring runs once, in the lane or in main(), and the phases whose times
are gated or whose learning bars follow the host's pace stay out of the
lane and out of its window. The lane's process reports its failure to
main() (here, where there is no card, its phases cannot start) and
stop() leaves nothing of it running. Phase "nodes" runs last in the
lane under its own deadline, and chip_multicard.py lists its three
phases across node managers."""

import importlib.util
import inspect
import os
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _phases(src):
    return re.findall(r'with phase\("([a-z_]+)"\)', src)


def _main():
    src = (REPO / "chip_smoke.py").read_text()
    return src[src.index("def main("):src.index("def thread_cpu_s(")]


def test_every_phase_runs_once_in_the_lane_or_in_main():
    lane = _phases(inspect.getsource(chip_smoke.lane_entry))
    main = _phases(_main())
    assert tuple(lane) == chip_smoke.LANE_PHASES
    listed = re.findall(r"^ {1,2}\d+\. (?:the )?([a-z_]+)",
                        chip_smoke.__doc__, re.MULTILINE)
    assert len(listed) == 21
    assert sorted(main + lane) == sorted(listed + ["server"])
    # the capture first, in a process no other profiler session has run in
    assert lane[0] == "server"


@pytest.mark.parametrize("alone", ["kernels", "llama", "impala", "tooling",
                                   "elastic", "examples"])
def test_gated_and_host_paced_phases_run_outside_the_lanes_window(alone):
    """The lane starts after "tooling" and is joined before "elastic"; the
    phases that time the kernels, gate a time or learn at the host's pace
    run before or after that window, in main()."""
    main = _main()
    start, join = main.index("lane = Lane("), main.index("lane.join()")
    at = main.index(f'with phase("{alone}")')
    assert alone not in chip_smoke.LANE_PHASES
    assert at < start or at > join


def test_nodes_runs_last_in_the_lane_under_its_own_deadline():
    """Phase "nodes" crosses a node manager's card hand-off in the lane,
    after "tools", and fails past NODES_S (90 s) of its own."""
    assert chip_smoke.LANE_PHASES[-2:] == ("tools", "nodes")
    assert chip_smoke.NODES_S == 90
    src = inspect.getsource(chip_smoke.run_nodes)
    assert "took > NODES_S" in src


def test_multicard_lists_the_phases_across_node_managers():
    spec = importlib.util.spec_from_file_location(
        "chip_multicard", REPO / "chip_multicard.py")
    multicard = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(multicard)
    assert {"nodes", "nodes_narrow", "nodes_rl"} <= set(multicard.PHASES)
    assert multicard.NODE_CARDS == ("0,1", "2,3")
    with pytest.raises(SystemExit):
        multicard.main(["--only", "nodes,bogus"])


def test_a_failed_lane_fails_the_run_and_stop_leaves_nothing(capsys,
                                                            monkeypatch):
    monkeypatch.setattr(chip_smoke, "LANE_S", 120)
    lane = chip_smoke.Lane(10.5, None)
    with pytest.raises(AssertionError, match="the lane exited"):
        lane.join()
    lane.stop()
    assert lane.proc.returncode not in (None, 0)
    assert not os.path.exists(lane.dir)
    assert "the lane started: phases server, parallel, rllib" in \
        capsys.readouterr().out


def test_stop_ends_a_running_lane():
    lane = chip_smoke.Lane(10.5, None)
    lane.stop()
    assert lane.proc.returncode is not None
    assert not os.path.exists(lane.dir)
