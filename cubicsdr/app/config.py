"""AppConfig / DeviceConfig — persisted settings.

Schema parity with src/AppConfig.h:20-110 (global: theme, perf mode
LOW/NORMAL/HIGH, snap, center freq, waterfall lines-per-second, spectrum
averaging, dB offset, recording path/options; per-device: ppm, offset, AGC,
sample rate, antenna, per-stage gains, stream opts, settings). Named
configs via the ``-c`` flag analog (ref: src/CubicSDR.h:262).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, asdict
from typing import Any

PERF_LOW, PERF_NORMAL, PERF_HIGH = 0, 1, 2      # ref: AppConfig.h:86-90


@dataclass
class DeviceConfig:
    ppm: int = 0
    offset: int = 0
    agc_mode: bool = True
    sample_rate: int = 0
    antenna: str = ""
    gains: dict = field(default_factory=dict)        # stage -> dB
    stream_opts: dict = field(default_factory=dict)
    settings: dict = field(default_factory=dict)
    rig_if: int = 0


@dataclass
class AppConfig:
    theme: str = "default"
    perf_mode: int = PERF_NORMAL
    snap: int = 1
    center_freq: int = 100_000_000
    waterfall_lps: int = 30
    spectrum_avg: float = 0.65
    db_offset: float = 0.0
    recording_path: str = ""
    recording_squelch_option: int = 0
    recording_file_time_limit: int = 0
    main_split: float = 0.5
    bookmarks_visible: bool = True
    devices: dict = field(default_factory=dict)      # device id -> DeviceConfig

    # --- per-device helpers (ref: AppConfig::getDevice) ---
    def get_device(self, device_id: str) -> DeviceConfig:
        if device_id not in self.devices:
            self.devices[device_id] = DeviceConfig()
        d = self.devices[device_id]
        if isinstance(d, dict):
            d = DeviceConfig(**d)
            self.devices[device_id] = d
        return d

    # --- persistence ---
    @staticmethod
    def config_dir() -> str:
        base = os.environ.get("XDG_CONFIG_HOME",
                              os.path.expanduser("~/.config"))
        d = os.path.join(base, "cubicsdr")
        os.makedirs(d, exist_ok=True)
        return d

    @staticmethod
    def config_path(name: str = "") -> str:
        fname = f"config{('-' + name) if name else ''}.json"
        return os.path.join(AppConfig.config_dir(), fname)

    def save(self, path: str | None = None, name: str = ""):
        path = path or self.config_path(name)
        d = asdict(self)
        with open(path, "w") as f:
            json.dump(d, f, indent=2)
        return path

    @staticmethod
    def load(path: str | None = None, name: str = "") -> "AppConfig":
        path = path or AppConfig.config_path(name)
        if not os.path.exists(path):
            return AppConfig()
        with open(path) as f:
            d = json.load(f)
        devices = {k: DeviceConfig(**v) for k, v in
                   d.pop("devices", {}).items()}
        cfg = AppConfig(**{k: v for k, v in d.items()
                           if k in AppConfig.__dataclass_fields__})
        cfg.devices = devices
        return cfg
