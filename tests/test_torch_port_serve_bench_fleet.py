"""The port's serving benchmark in the scenarios that start processes
(``--replicas``, ``--balancers``, ``--generations``) against the
reference's ``tools/serve_bench.py``.

Each runs at the smallest size that still runs the scenario's code: one
replica process (its sweep point, the data-path micro, the SIGKILL of
the replica under traffic and its heal), two doors over two null
replicas (one repeat of the sweep, the distributed quota, a door's
SIGKILL), two continual generations. The port runs in this process with
``--dev cpu`` (its replicas get ``dev=cpu``), the reference in a
process of its own on one XLA:CPU device (its bundles do not boot beside
the eight host devices this session's conftest makes). Both must end
clean (exit 0) with the same record keys and the same deterministic
fields.
"""

import pytest
import torch

from cxxnet_tpu_torch.tools import serve_bench as port_sb
from test_torch_port_serve_bench import _fields, _keys, _ref_process, _run


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("argv,skip", [
    (["--replicas", "1", "--requests", "4",
      "--fleet-clients-per-replica", "2"], ()),
    (["--balancers", "2", "--requests", "4", "--front-clients", "4",
      "--front-repeats", "1"], ()),
    # the clients drive until the last generation deploys
    (["--generations", "2", "--requests", "4"], ("requests_ok",)),
], ids=["replicas", "balancers", "generations"])
def test_fleet_scenario_matches_reference(argv, skip, capsys):
    rc, ref, _ = _ref_process(argv)
    prc, port, err = _run(port_sb, argv, capsys)
    assert prc == rc == 0, err[-3000:]
    assert _keys(port) == _keys(ref)
    assert _fields(port, skip) == _fields(ref, skip)
    assert port["zero_recompiles"] and port["platform"] == "cpu"
    if "--replicas" in argv:
        kill = port["kill_replica"]
        assert kill["replica_killed"] and kill["self_healed"]
        assert kill["requests_failed"] == 0
        assert "# killed replica r" in err
    elif "--balancers" in argv:
        q = port["distributed_quota"]
        assert q["within_bound"] and q["typed_429_every_door"]
        assert port["kill_balancer"]["requests_failed"] == 0
        assert port["door_telemetry"]["route_balancers"] == ["b0", "b1"]
    else:
        assert port["generations_deployed"] == 2 and port["hot_swaps"] == 1
        assert port["requests_failed"] == 0
