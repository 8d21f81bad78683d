"""The port's cost-model-adaptive commit controller (khipu_tpu_torch
sync/adaptive.py) against the JAX package's: the probe gate, the EWMA
Schmitt trigger (flip without flapping), the port's defaults, and the
end-to-end replay — a device-commit
replay whose probe reports a slow gather commits on the host and lands
on the reference's chain. The unit cases run both controllers on the
same observations and hold their decisions equal."""

import dataclasses

import khipu_tpu.sync.adaptive as jx_adaptive
from khipu_tpu.config import SyncConfig as JxSyncConfig

import khipu_tpu_torch.sync.adaptive as adaptive_mod
from khipu_tpu_torch import workloads
from khipu_tpu_torch.config import SyncConfig
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.ledger.window import WINDOW_GAUGES
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.sync.adaptive import (
    ADAPTIVE_GAUGES,
    AdaptiveCommitController,
    ProbeResult,
    probe_backend,
)
from khipu_tpu_torch.sync.replay import ReplayDriver
from khipu_tpu_torch.trie import fused


def _sync_cfg(**overrides):
    overrides.setdefault("adaptive_probe", False)  # unit tests doctor it
    return SyncConfig(**overrides)


def _slow_probe(platform="doctored"):
    """A device whose gather LOSES to the host memcpy 100x."""
    return ProbeResult(platform, 1e6, 1e8, False)


def _fast_probe(platform="doctored-hbm"):
    return ProbeResult(platform, 1e11, 1e9, True)


def _pair(**overrides):
    """The port's controller and the reference's on the same settings,
    with the reference's host floor set to the port's (each calibrates
    its own Keccak)."""
    overrides.setdefault("adaptive_probe", False)
    port = AdaptiveCommitController(SyncConfig(**overrides), device_cap=True,
                                    device="cpu")
    ref = jx_adaptive.AdaptiveCommitController(JxSyncConfig(**overrides),
                                               device_cap=True)
    ref.host_floor_s = port.host_floor_s
    return port, ref


def _state(c):
    return (c.mode(), c.flips, c.flaps_suppressed, c.windows)


class TestProbeGate:
    def test_doctored_slow_d2d_backend_starts_in_host_mode(
            self, monkeypatch):
        """The probe cannot clear the margin, so the controller
        downgrades to host commit BEFORE the first window."""
        monkeypatch.setattr(adaptive_mod, "probe_backend",
                            lambda margin, device=None: _slow_probe())
        ctrl = AdaptiveCommitController(
            _sync_cfg(adaptive_probe=True), device_cap=True, device="cpu")
        assert ctrl.mode() == "host"
        assert not ctrl.device_mode
        assert ctrl.flips == 1  # the probe downgrade is a counted flip
        assert ADAPTIVE_GAUGES["device_mode"] == 0

    def test_fast_d2d_backend_keeps_device_mode(self, monkeypatch):
        monkeypatch.setattr(adaptive_mod, "probe_backend",
                            lambda margin, device=None: _fast_probe())
        ctrl = AdaptiveCommitController(
            _sync_cfg(adaptive_probe=True), device_cap=True, device="cpu")
        assert ctrl.mode() == "device"
        assert ctrl.flips == 0

    def test_no_device_cap_never_probes_never_flips(self):
        ctrl = AdaptiveCommitController(_sync_cfg(adaptive_probe=True),
                                        device_cap=False, device="cpu")
        assert ctrl.mode() == "host"
        assert ctrl.probe is None
        # a miraculous device EWMA cannot upgrade past the config cap
        ctrl._ewma["device"] = 1e-12
        ctrl._dwell = 10**6
        ctrl.observe_window("host", 100, 1.0)
        assert ctrl.mode() == "host" and ctrl.flips == 0

    def test_cpu_probe_is_cached_and_reports_no_device(self):
        """On a CPU device the probe touches no CUDA, times nothing and
        reports ``device_ok=False``, as the reference's does on a CPU
        backend; the answer is cached per device."""
        p1 = probe_backend(margin=1.5, device="cpu")
        p2 = probe_backend(margin=1.5, device="cpu")
        assert p1 is p2
        assert (p1.platform, p1.device_ok) == ("cpu", False)
        assert p1.d2d_bytes_per_s == p1.memcpy_bytes_per_s == 0.0


class TestSchmittTrigger:
    def _device_pair(self, **overrides):
        port, ref = _pair(**overrides)
        for c in (port, ref):
            c.probe = _fast_probe()  # probe said ok; EWMAs now decide
        return port, ref

    def test_slow_device_windows_flip_to_host_after_dwell(self):
        """Device windows costing 100x the host floor per hash flip the
        mode, but only after ``adaptive_dwell_windows`` in device mode,
        and never oscillate back — in step with the reference."""
        port, ref = self._device_pair()
        dwell = port.cfg.adaptive_dwell_windows
        slow = 100.0 * port.host_floor_s
        for i in range(dwell - 1):
            for c in (port, ref):
                c.observe_window("device", 1000, 1000 * slow)
            assert port.mode() == "device", f"flipped early at {i}"
            assert _state(port) == _state(ref)
        assert port.flaps_suppressed == dwell - 1
        for c in (port, ref):
            c.observe_window("device", 1000, 1000 * slow)
        assert port.mode() == "host" and port.flips == 1
        for _ in range(3 * dwell):
            for c in (port, ref):
                c.observe_window("host", 1000, 1000 * c.host_floor_s)
        assert port.mode() == "host" and port.flips == 1
        assert _state(port) == _state(ref)

    def test_hysteresis_band_blocks_flap(self):
        """A ratio inside (flip_back_ratio, flip_ratio) moves nothing."""
        port, ref = self._device_pair()
        for c in (port, ref):
            c._dwell = 10**6
            for _ in range(20):
                c.observe_window("device", 1000, 1000 * c.host_floor_s)
        assert port.mode() == "device" and port.flips == 0
        assert _state(port) == _state(ref)

    def test_flip_back_needs_probe_ok_and_low_ratio(self):
        """Host mode flips back to device only when the device EWMA is
        below ``flip_back_ratio`` x host AND the probe cleared the
        device."""
        port, ref = self._device_pair()
        for c in (port, ref):
            c.device_mode = False
            c._ewma["device"] = 0.1 * c.host_floor_s
            c._dwell = 10**6
            c.probe = _slow_probe()
            c.observe_window("host", 1000, 1000 * c.host_floor_s)
        assert port.mode() == "host"  # probe veto holds
        for c in (port, ref):
            c.probe = _fast_probe()
            c.observe_window("host", 1000, 1000 * c.host_floor_s)
        assert port.mode() == "device" and port.flips == 1
        assert _state(port) == _state(ref)

    def test_gauges_track_the_controller(self):
        port, _ = self._device_pair()
        port.observe_window("device", 10, 10 * port.host_floor_s)
        assert ADAPTIVE_GAUGES["windows_observed"] == port.windows
        assert ADAPTIVE_GAUGES["device_mode"] == int(port.device_mode)
        assert ADAPTIVE_GAUGES["ewma_device_hash_s"] > 0


class TestPortDefaults:
    def test_sync_defaults_are_the_references_but_adaptive_commit(self):
        """Every windowed-commit knob the port keeps has the JAX
        package's default, except ``adaptive_commit``: off in the port,
        so a card replay at defaults keeps every window on the device."""
        port, ref = SyncConfig(), JxSyncConfig()
        names = [f.name for f in dataclasses.fields(SyncConfig)
                 if f.name.startswith(("adaptive_", "pipeline_", "commit_",
                                       "mirror_", "device_mirror",
                                       "collector_", "degrade_"))]
        assert len(names) >= 12
        for name in names:
            if name == "adaptive_commit":
                assert port.adaptive_commit is False
                assert ref.adaptive_commit is True
            else:
                assert getattr(port, name) == getattr(ref, name), name
        assert not hasattr(port, "adaptive_depth_max")

    def test_default_replay_runs_every_window_fused(self):
        """A device-commit replay at the port's defaults builds no
        controller and resolves every window in one fused launch."""
        dispatches = fused.FUSED_GAUGES["dispatches"]
        host_windows = WINDOW_GAUGES["host_windows"]
        cfg = workloads.replay_config(commit_window_blocks=2)
        _, spec, blocks = workloads.transfer_chain(cfg, 4, 1, senders=2)
        bc = Blockchain(Storages(), cfg)
        bc.load_genesis(spec)
        driver = ReplayDriver(bc, cfg, device_commit=True, device="cpu")
        assert driver.replay(blocks).blocks == 4
        assert driver.adaptive is None
        assert fused.FUSED_GAUGES["dispatches"] == dispatches + 2
        assert WINDOW_GAUGES["host_windows"] == host_windows

    def test_controller_never_touches_the_pipeline_depth(self):
        """The controller decides the mode only: a replay whose windows
        all flip it to host keeps its configured ``pipeline_depth``."""
        from khipu_tpu_torch.sync.replay import PIPELINE_GAUGES

        cfg = workloads.replay_config(commit_window_blocks=2,
                                      pipeline_depth=3,
                                      adaptive_commit=True)
        _, spec, blocks = workloads.transfer_chain(cfg, 6, 1, senders=2)
        bc = Blockchain(Storages(), cfg)
        bc.load_genesis(spec)
        driver = ReplayDriver(bc, cfg, device_commit=True, device="cpu")
        assert driver.replay(blocks).blocks == 6
        assert driver.adaptive.mode() == "host"
        assert PIPELINE_GAUGES["depth"] == 3
        assert not hasattr(driver.adaptive, "depth_hint")


class TestAdaptiveReplay:
    def test_slow_probe_replay_commits_on_host_and_matches_reference(
            self, monkeypatch):
        """A device-commit replay (a deploy and two blocks of token
        transfers) whose probe reports a slow gather runs every window
        through the host level loop (no fused dispatch) and lands on the
        same chain as the JAX package's windowed replay."""
        from tests.test_torch_window import _assert_same_chain, _jx_cfg

        monkeypatch.setattr(adaptive_mod, "probe_backend",
                            lambda margin, device=None: _slow_probe())
        dispatches = fused.FUSED_GAUGES["dispatches"]
        host_windows = WINDOW_GAUGES["host_windows"]
        cfg = workloads.replay_config(commit_window_blocks=2,
                                      pipeline_depth=2,
                                      adaptive_commit=True)
        builder, spec, blocks = workloads.erc20_chain(cfg, 2, 3, 4)
        wire = [b.encode() for b in blocks]
        bc = Blockchain(Storages(), cfg)
        bc.load_genesis(spec)
        driver = ReplayDriver(bc, cfg, device_commit=True, device="cpu")
        stats = driver.replay([Block.decode(w) for w in wire])
        assert stats.blocks == 3
        assert ADAPTIVE_GAUGES["device_mode"] == 0
        assert driver.adaptive.windows == 2
        assert fused.FUSED_GAUGES["dispatches"] == dispatches
        assert WINDOW_GAUGES["host_windows"] == host_windows + 2

        import khipu_tpu.domain.blockchain as jxb
        from khipu_tpu.domain.block import Block as JxBlock
        from khipu_tpu.storage.storages import Storages as JxStorages
        from khipu_tpu.sync.replay import ReplayDriver as JxReplayDriver

        jx_cfg = _jx_cfg(2)
        ref = jxb.Blockchain(JxStorages(), jx_cfg)
        ref.load_genesis(jxb.GenesisSpec(alloc=spec.alloc,
                                         gas_limit=spec.gas_limit))
        JxReplayDriver(ref, jx_cfg).replay([JxBlock.decode(w) for w in wire])
        _assert_same_chain(bc, ref, 3)
