"""The port deployed from its launchers, against the reference's.

* Full stack: ``test_full_stack_from_clis`` (``tests/test_launchers.py``)
  on the port. Real processes of ``python -m
  dragonfly2_tpu_torch.tools.{manager,daemon,scheduler,trainer}``: a seed
  daemon registers with the manager, the scheduler finds it there, the
  trainer attaches, REST lists the instances, and a leecher daemon that
  knows only the manager serves a ``dfget`` CLI pull of a seeded 4 MiB
  ``file://`` origin over the mesh. The daemons and the trainer run on
  the CPU (``"device": "cpu"``). The output's bytes equal the origin's,
  the leecher logs no origin byte and the seed logs the whole file.
* Launcher flags: each launcher's ``build_parser()`` has the reference's
  option strings and defaults; the flags of subsystems not ported yet
  exit non-zero naming them; the trainer launcher without a card and
  without ``"device": "cpu"`` exits non-zero.
* Config: the YAML subset and the DF_* overlay parse as the reference's.

Every process gets a deadline of its own, well under a minute.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu.common import config as ref_config
from dragonfly2_tpu.tools import daemon as ref_daemon_cli
from dragonfly2_tpu.tools import dfget as ref_dfget_cli
from dragonfly2_tpu.tools import manager as ref_manager_cli
from dragonfly2_tpu.tools import scheduler as ref_scheduler_cli
from dragonfly2_tpu.tools import trainer as ref_trainer_cli
from dragonfly2_tpu_torch.common import config as port_config
from dragonfly2_tpu_torch.tools import daemon as daemon_cli
from dragonfly2_tpu_torch.tools import dfget as dfget_cli
from dragonfly2_tpu_torch.tools import manager as manager_cli
from dragonfly2_tpu_torch.tools import scheduler as scheduler_cli
from dragonfly2_tpu_torch.tools import trainer as trainer_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
BOOT_S = 45.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra) -> dict:
    # no card for the port's processes here: the device probe answers at
    # once instead of waiting on a runtime
    return {**os.environ, "PYTHONPATH": REPO, "PYTHONUNBUFFERED": "1",
            "CUDA_VISIBLE_DEVICES": "", **extra}


class Service:
    """A launcher subprocess whose merged output a reader thread keeps,
    so a test can wait on a line with a deadline."""

    def __init__(self, name: str, *args: str, workdir=None):
        self.proc = subprocess.Popen(
            [PY, "-m", f"dragonfly2_tpu_torch.tools.{name}", *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(), cwd=str(workdir or REPO))
        self.lines: list[str] = []
        self._cv = threading.Condition()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line)
                self._cv.notify_all()
        with self._cv:
            self.lines.append(None)
            self._cv.notify_all()

    def wait_line(self, needle: str, timeout: float = BOOT_S) -> str:
        deadline = time.monotonic() + timeout
        seen = 0
        with self._cv:
            while True:
                for line in self.lines[seen:]:
                    if line is None:
                        raise RuntimeError(f"process died: {self.text()}")
                    if needle in line:
                        return line
                seen = len(self.lines)
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{needle!r} not seen: {self.text()}")
                self._cv.wait(left)

    def text(self) -> str:
        return "".join(x for x in self.lines if x)[-3000:]

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
            return -9


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def test_full_stack_from_clis(tmp_path):
    blob = np.random.default_rng(4).integers(
        0, 256, 4 << 20, dtype=np.uint8).tobytes()
    origin = tmp_path / "www" / "blob.bin"
    origin.parent.mkdir()
    origin.write_bytes(blob)
    url = "file://" + str(origin)
    services: list[Service] = []
    try:
        grpc_port, rest_port = free_port(), free_port()
        mgr = Service("manager", "--grpc-port", str(grpc_port),
                      "--rest-port", str(rest_port), "--listen-ip",
                      "127.0.0.1", "--workdir", str(tmp_path / "mgr"),
                      "--db", str(tmp_path / "mgr" / "m.db"))
        services.append(mgr)
        mgr.wait_line("manager up:")
        mgr_addr = f"127.0.0.1:{grpc_port}"

        # the seed daemon registers itself with the manager
        seed_rpc, seed_up = free_port(), free_port()
        seed_cfg = tmp_path / "seed.json"
        seed_cfg.write_text(json.dumps({
            "workdir": str(tmp_path / "seed"), "host_ip": "127.0.0.1",
            "listen_ip": "127.0.0.1", "hostname": "seed-cli",
            "is_seed": True, "rpc_port": seed_rpc,
            "manager_addresses": [mgr_addr], "upload": {"port": seed_up},
            "device": "cpu"}))
        seed = Service("daemon", "--config", str(seed_cfg))
        services.append(seed)
        seed.wait_line("daemon up:")

        # the scheduler finds the seed through the manager
        sched_port = free_port()
        sched = Service("scheduler", "--port", str(sched_port),
                        "--listen-ip", "127.0.0.1",
                        "--advertise-ip", "127.0.0.1", "--manager", mgr_addr)
        services.append(sched)
        sched.wait_line("scheduler up:")

        # the trainer attaches to the manager too
        trainer_cfg = tmp_path / "trainer.json"
        trainer_cfg.write_text(json.dumps({"device": "cpu"}))
        trainer = Service("trainer", "--config", str(trainer_cfg),
                          "--listen-ip", "127.0.0.1", "--manager", mgr_addr,
                          "--data-dir", str(tmp_path / "tr"))
        services.append(trainer)
        trainer.wait_line("trainer up:")

        # the manager's REST lists both registered instances as active
        rest = f"http://127.0.0.1:{rest_port}"
        scheds = _get_json(rest + "/api/v1/schedulers")
        assert [(s["port"], s["state"]) for s in scheds] == \
            [(sched_port, "active")]
        seeds = _get_json(rest + "/api/v1/seed-peers")
        assert [(s["port"], s["download_port"], s["state"])
                for s in seeds] == [(seed_rpc, seed_up, "active")]
        assert " seeds=1)" in sched.wait_line("scheduler up on")
        assert "manager attach failed" not in sched.text() + seed.text()

        # a leecher that knows only the manager, and the dfget CLI
        sock = str(tmp_path / "leech.sock")
        leech_cfg = tmp_path / "leech.json"
        leech_cfg.write_text(json.dumps({
            "workdir": str(tmp_path / "leech"), "host_ip": "127.0.0.1",
            "listen_ip": "127.0.0.1", "hostname": "leech-cli",
            "unix_sock": sock, "manager_addresses": [mgr_addr],
            "device": "cpu"}))
        leech = Service("daemon", "--config", str(leech_cfg))
        services.append(leech)
        line = leech.wait_line("daemon up:")
        assert f"schedulers=['127.0.0.1:{sched_port}']" in line, line

        out = tmp_path / "out.bin"
        rc = subprocess.run(
            [PY, "-m", "dragonfly2_tpu_torch.tools.dfget", url, "-O",
             str(out), "--daemon-sock", sock, "--quiet"],
            env=_env(), cwd=REPO, capture_output=True, text=True,
            timeout=BOOT_S)
        assert rc.returncode == 0, rc.stderr[-2000:]
        assert out.read_bytes() == blob
        # every leecher byte came from a peer; the seed read the origin
        done = leech.wait_line("task success:")
        assert f"p2p={len(blob)} src=0)" in done, done
        done = seed.wait_line("task success:")
        assert f"p2p=0 src={len(blob)})" in done, done
        assert "manager attach failed" not in leech.text()
    finally:
        codes = [s.stop() for s in reversed(services)]
    assert codes == [0] * len(services), [s.text() for s in services]


def test_dfget_shard_subset_from_a_launched_daemon(tmp_path):
    """``dfget --shards --shard-manifest`` through a launched daemon with
    no scheduler: one ``(tree)`` ready line per requested shard, the
    requested range's bytes in the output, and only the covering piece
    taken from the origin."""
    piece = 4 << 20
    blob = np.random.default_rng(5).integers(
        0, 256, 3 * piece, dtype=np.uint8).tobytes()
    origin = tmp_path / "ckpt.bin"
    origin.write_bytes(blob)
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps({"shards": [
        {"name": f"s{i}", "range_start": i * piece, "range_size": piece}
        for i in range(3)]}))
    sock = str(tmp_path / "d.sock")
    cfg = tmp_path / "d.json"
    cfg.write_text(json.dumps({
        "workdir": str(tmp_path / "d"), "host_ip": "127.0.0.1",
        "listen_ip": "127.0.0.1", "hostname": "shards-cli",
        "unix_sock": sock, "device": "cpu"}))
    daemon = Service("daemon", "--config", str(cfg))
    try:
        daemon.wait_line("daemon up:")
        out = tmp_path / "out.bin"
        rc = subprocess.run(
            [PY, "-m", "dragonfly2_tpu_torch.tools.dfget",
             "file://" + str(origin), "-O", str(out), "--daemon-sock", sock,
             "--shard-manifest", str(manifest), "--shards", "s1"],
            env=_env(), cwd=REPO, capture_output=True, text=True,
            timeout=BOOT_S)
        assert rc.returncode == 0, rc.stderr[-2000:]
        ready = [ln for ln in rc.stdout.splitlines() if " ready " in ln]
        assert len(ready) == 1, rc.stdout
        assert "shard s1 ready [1/1] (tree)" in ready[0], ready
        assert out.read_bytes()[piece:2 * piece] == blob[piece:2 * piece]
        done = daemon.wait_line("task success:")
        assert f"{piece} bytes, 1 pieces (p2p=0 src={piece})" in done, done
    finally:
        assert daemon.stop() == 0, daemon.text()


def test_dfget_shards_without_manifest_exits_2(capsys):
    with pytest.raises(SystemExit) as exc:
        dfget_cli.main(["u", "-O", "o", "--shards", "a"])
    assert exc.value.code == 2
    assert "--shards requires --shard-manifest" in capsys.readouterr().err


# ---------------------------------------------------------------- flags

PARSERS = [(manager_cli, ref_manager_cli), (scheduler_cli, ref_scheduler_cli),
           (trainer_cli, ref_trainer_cli), (daemon_cli, ref_daemon_cli),
           (dfget_cli, ref_dfget_cli)]


def _flags(parser) -> list[tuple]:
    return [(tuple(a.option_strings), a.dest, a.default, a.type, a.nargs,
             a.required, tuple(a.choices) if a.choices else None)
            for a in parser._actions]


@pytest.mark.parametrize("port,ref", PARSERS,
                         ids=[p.__name__.rsplit(".", 1)[1] for p, _ in PARSERS])
def test_launcher_flags_match_reference(port, ref):
    p, r = port.build_parser(), ref.build_parser()
    assert p.prog == r.prog
    assert _flags(p) == _flags(r)


@pytest.mark.parametrize("module,argv,names", [
    (manager_cli, ["--auth"], "REST auth"),
    (manager_cli, ["--issue-certs"], "certificate issuance"),
    (dfget_cli, ["u", "-O", "o", "--recursive"], "recursive"),
    (dfget_cli, ["u", "-O", "o", "-r"], "recursive"),
])
def test_unported_flags_exit_nonzero(module, argv, names, capsys):
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported" in err and names in err, err


@pytest.mark.parametrize("argv", [
    ["--tenant", "batch"], ["--qos-class", "bulk"],
    ["--tenant", "serving", "--qos-class", "critical"]])
def test_dfget_carries_tenant_and_class_in_url_meta(argv):
    """``--tenant`` and ``--qos-class`` (refused until the QoS plane was
    ported) ride the request's UrlMeta, as the reference's do."""
    full = ["http://o/x", "-O", "o"] + argv
    port = dfget_cli._meta(dfget_cli.build_parser().parse_args(full))
    ref = ref_dfget_cli._meta(ref_dfget_cli.build_parser().parse_args(full))
    assert (port.tenant, port.qos_class) == (ref.tenant, ref.qos_class)
    assert port.tenant or port.qos_class


def test_scheduler_with_algorithm_nt_starts(tmp_path):
    """``--algorithm nt`` (refused until the probes were ported) starts a
    scheduler that rules with the RTT evaluator, and stops cleanly."""
    sched = Service("scheduler", "--listen-ip", "127.0.0.1", "--port",
                    str(free_port()), "--algorithm", "nt", workdir=tmp_path)
    try:
        line = sched.wait_line("scheduler up:")
        assert "algorithm=nt" in sched.text(), sched.text()
        assert "not ported" not in sched.text()
    finally:
        assert sched.stop() == 0, sched.text()
    assert line


def test_manager_config_with_unported_options_exits_nonzero(tmp_path,
                                                            capsys):
    cfg = tmp_path / "m.yaml"
    cfg.write_text("grpc_port: 0\nissue_certs: true\n")
    with pytest.raises(SystemExit) as exc:
        manager_cli.main(["--config", str(cfg)])
    assert exc.value.code == 2
    assert "issue_certs" in capsys.readouterr().err


def test_trainer_launcher_without_a_card_exits_nonzero(tmp_path):
    """No card and no ``"device": "cpu"``: the launcher exits non-zero,
    and does not fit on the CPU instead."""
    proc = subprocess.run(
        [PY, "-m", "dragonfly2_tpu_torch.tools.trainer", "--listen-ip",
         "127.0.0.1", "--data-dir", str(tmp_path / "tr")],
        env=_env(), cwd=REPO, capture_output=True, text=True,
        timeout=BOOT_S)
    assert proc.returncode != 0
    assert "trainer up:" not in proc.stdout
    assert "CUDA" in proc.stderr, proc.stderr[-2000:]


# ---------------------------------------------------------------- config

YAML = """
# a daemon config in the subset
workdir: /tmp/df
is_seed: yes
rpc_port: 65002
manager_addresses:
  - 10.0.0.1:65003
  - "10.0.0.2:65003"
scheduler:
  refresh_interval_s: 2.5
  addresses:
    - 10.0.0.9:8002
upload:
  port: 65004
hostname: 'leech-a'
listen_ip: ~
"""


def test_yaml_subset_and_env_overlay_match_reference(monkeypatch):
    assert port_config._parse_yaml(YAML) == ref_config._mini_yaml(YAML)
    monkeypatch.setenv("DF_SCHEDULER__REFRESH_INTERVAL_S", "7")
    monkeypatch.setenv("DF_IS_SEED", "false")
    monkeypatch.setenv("DF_WORKDIR", "/elsewhere")
    assert port_config.env_overrides() == ref_config.env_overrides()
    assert port_config.env_overrides()["scheduler"] == \
        {"refresh_interval_s": 7}
