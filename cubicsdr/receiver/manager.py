"""DemodulatorMgr — registry, navigation, hit-testing, last-state defaults.

Parity with src/demod/DemodulatorMgr.cpp:
  - newThread/deleteThread/terminateAll (:35-60,143-168) -> create/remove/clear
  - ordered navigation by frequency (:67-141)
  - getDemodulatorsAt hit-testing with USB/LSB one-sided bandwidth (:170-188)
  - active-vs-last-active semantics (:208-287)
  - "last state" defaults seeding the next demod (:308-335)
  - save/load instances (:417-560) as plain dicts (JSON-ready)
"""

from __future__ import annotations

from typing import Optional

from cubicsdr.receiver.instance import DemodulatorInstance


class DemodulatorMgr:
    def __init__(self):
        self.demods: list[DemodulatorInstance] = []
        self._active: Optional[DemodulatorInstance] = None
        self._last_active: Optional[DemodulatorInstance] = None
        # last-state defaults for the next demod created
        self.last_bandwidth = 200000.0
        self.last_demod_type = "FM"
        self.last_squelch_level = -100.0
        self.last_squelch_enabled = False
        self.last_gain = 1.0
        self.last_modem_settings: dict[str, dict] = {}

    # --- lifecycle ---
    def new_demodulator(self, frequency: float,
                        demod_type: Optional[str] = None,
                        bandwidth: Optional[float] = None
                        ) -> DemodulatorInstance:
        inst = DemodulatorInstance(
            frequency=frequency,
            bandwidth=bandwidth or self.last_bandwidth,
            demod_type=demod_type or self.last_demod_type)
        inst.squelch_level = self.last_squelch_level
        inst.squelch_enabled = self.last_squelch_enabled
        inst.gain = self.last_gain
        inst.write_modem_settings(
            self.last_modem_settings.get(inst.demod_type, {}))
        self.demods.append(inst)
        return inst

    def delete_demodulator(self, inst: DemodulatorInstance):
        if inst in self.demods:
            self.demods.remove(inst)
        if self._active is inst:
            self._active = None
        if self._last_active is inst:
            self._last_active = None

    def terminate_all(self):
        self.demods.clear()
        self._active = None
        self._last_active = None

    def get_demodulators(self) -> list[DemodulatorInstance]:
        return list(self.demods)

    # --- ordered navigation (ref :67-141) ---
    def _ordered(self):
        return sorted(self.demods, key=lambda d: d.frequency)

    def get_next_demodulator(self, inst) -> Optional[DemodulatorInstance]:
        o = self._ordered()
        if not o:
            return None
        if inst not in o:
            return o[0]
        i = o.index(inst)
        return o[i + 1] if i + 1 < len(o) else None

    def get_previous_demodulator(self, inst) -> Optional[DemodulatorInstance]:
        o = self._ordered()
        if not o:
            return None
        if inst not in o:
            return o[-1]
        i = o.index(inst)
        return o[i - 1] if i > 0 else None

    def get_first_demodulator(self):
        o = self._ordered()
        return o[0] if o else None

    def get_last_demodulator(self):
        o = self._ordered()
        return o[-1] if o else None

    # --- hit testing (ref :170-188) ---
    def get_demodulators_at(self, freq: float, bandwidth: float = 0.0
                            ) -> list[DemodulatorInstance]:
        hits = []
        for d in self.demods:
            half = d.bandwidth / 2
            center = d.frequency + d.halfband_offset()
            if d.demod_type in ("USB", "LSB"):
                half = d.bandwidth / 4
            if abs(freq - center) <= half + bandwidth / 2:
                hits.append(d)
        return hits

    # --- active semantics (ref :208-287) ---
    def set_active_demodulator(self, inst: Optional[DemodulatorInstance],
                               temporary: bool = True):
        if inst is not None and not temporary:
            self._last_active = inst
            self._update_last_state(inst)
        self._active = inst

    def get_active_demodulator(self):
        return self._active

    def get_last_active_demodulator(self):
        return self._last_active

    # --- last-state defaults (ref :308-335) ---
    def _update_last_state(self, inst: DemodulatorInstance):
        self.last_bandwidth = inst.bandwidth
        self.last_demod_type = inst.demod_type
        self.last_squelch_level = inst.squelch_level
        self.last_squelch_enabled = inst.squelch_enabled
        self.last_gain = inst.gain
        self.last_modem_settings[inst.demod_type] = inst.read_modem_settings()

    # --- follow / delta-lock / range sweep (ref: SDRPostThread.cpp:44-98)
    def update_active_demodulators(self, center_freq: float,
                                   sample_rate: float) -> float:
        """The per-block activation sweep the reference runs before every
        channelized block: delta-locked demods ride the device center;
        out-of-range demods deactivate (unless follow/tracking); a FOLLOW
        demod that fell out of range retunes the DEVICE CENTER to itself
        (one-shot). Returns the possibly-moved center frequency."""
        new_center = float(center_freq)
        for d in self.get_demodulators():
            if d.delta_lock:
                want = center_freq + d.delta_lock_ofs
                if d.frequency != want:
                    d.frequency = want
                    d.follow = False
                    d.tracking = False
            if abs(center_freq - d.frequency) > sample_rate / 2:
                if self._last_active is d:
                    d.active = False
                elif d.active and not d.follow and not d.tracking:
                    d.active = False
                if d.follow and center_freq != d.frequency:
                    new_center = float(d.frequency)   # move the device
                    d.follow = False
            elif not d.active:
                d.active = True
                if self._last_active is None:
                    self.set_active_demodulator(d, temporary=False)
        return new_center

    # --- persistence ---
    def save_instances(self) -> list[dict]:
        return [d.save() for d in self.demods]

    def load_instances(self, dicts: list[dict]):
        self.terminate_all()
        for d in dicts:
            self.demods.append(DemodulatorInstance.load(d))
