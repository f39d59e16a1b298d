# -*- coding: utf-8 -*-
"""
Kurtosis onset generator: an alternative Onset implementation using the
positive gradient of a rolling-kurtosis characteristic function (Baillard
et al., 2014). The reference framework advertises kurtosis onsets as an
extension point without shipping one (README.md:46); this is a native
implementation that plugs into QuakeScan exactly like STALTAOnset.

"""

import logging

import numpy as np

import quakemigrate_tpu.util as util
from quakemigrate_tpu.ops.kurtosis import kurtosis_onset
from quakemigrate_tpu.seis import Stream
from .base import Onset, OnsetData, gather_phase_waveforms
from .stalta import pre_process


class KurtosisOnset(Onset):
    """
    Onset functions from the rectified gradient of rolling kurtosis.

    Attributes
    ----------
    phases, bandpass_filters, channel_maps, channel_counts : as STALTAOnset.
    kurtosis_windows : dict of float
        Trailing kurtosis window length per phase, in seconds.
    smoothing_window : float
        Smoothing applied to the characteristic function, in seconds.
    min_onset_value : float
        Clip floor for the combined onset (>= 0.01).

    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        self.min_onset_value = kwargs.get("min_onset_value", 0.4)
        if self.min_onset_value < 0.01:
            raise ValueError("The `min_onset_value` must be greater than 0.01")

        self.phases = kwargs.get("phases", ["P", "S"])
        self.bandpass_filters = kwargs.get(
            "bandpass_filters", {"P": [2.0, 16.0, 2], "S": [2.0, 16.0, 2]}
        )
        self.kurtosis_windows = kwargs.get(
            "kurtosis_windows", {"P": 1.0, "S": 1.0}
        )
        self.smoothing_window = kwargs.get("smoothing_window", 0.05)
        self.channel_maps = kwargs.get(
            "channel_maps", {"P": "*Z", "S": "*[N,E,1,2]"}
        )
        self.channel_counts = kwargs.get("channel_counts", {"P": 1, "S": 2})

        self.all_channels = kwargs.get("all_channels", False)
        self.allow_gaps = kwargs.get("allow_gaps", False)
        self.full_timespan = kwargs.get("full_timespan", True)

    def __str__(self):
        out = (
            "\tOnset parameters - using the kurtosis onset"
            f"\n\t\tOnset function sampling rate = {self.sampling_rate} Hz"
            f"\n\t\tPhase(s) = {self.phases}\n"
        )
        for phase, filt in self.bandpass_filters.items():
            out += f"\n\t\t{phase} bandpass filter = {filt} (Hz, Hz, -)"
        out += "\n"
        for phase, win in self.kurtosis_windows.items():
            out += f"\n\t\t{phase} kurtosis window = {win} (s)"
        out += "\n"

        return out

    def calculate_onsets(self, data, timespan=None):
        """Calculate kurtosis onsets for all requested stations/phases."""

        onsets = []
        onsets_dict = {}
        filtered_waveforms = Stream()
        availability = {}

        for phase in self.phases:
            phase_waveforms = data.waveforms.select(
                channel=self.channel_maps[phase]
            )

            nkurt = util.time2sample(
                self.kurtosis_windows[phase], self.sampling_rate
            ) + 1
            nsmooth = max(
                1, util.time2sample(self.smoothing_window, self.sampling_rate)
            )

            filtered_phase_waveforms = pre_process(
                phase_waveforms,
                self.sampling_rate,
                data.resample,
                data.upfactor,
                self.bandpass_filters[phase],
                data.starttime,
                data.endtime,
            )

            # Availability-filter per station (shared helper: drops failed
            # channels and gap-fills when gaps / partial data are
            # tolerated, keeping the batch a fixed shape), then batch the
            # WHOLE phase's channel rows into ONE device call (a
            # per-station call would pay a dispatch round-trip each)
            kept, phase_avail = gather_phase_waveforms(
                self, data, phase, filtered_phase_waveforms
            )
            availability.update(phase_avail)

            rows = []
            station_slices = {}
            for station, waveforms in kept.items():
                lo = len(rows)
                rows.extend(
                    np.asarray(tr.data, dtype=np.float64) for tr in waveforms
                )
                station_slices[station] = slice(lo, len(rows))

            if not rows:
                continue

            cf_rows = np.array(
                kurtosis_onset(np.stack(rows), nkurt, nsmooth)
            )
            for station, sl in station_slices.items():
                onsets_dict.setdefault(station, {}).update(
                    {phase: self._combine(cf_rows[sl], nkurt, timespan)}
                )
                onsets.append(onsets_dict[station][phase])
                filtered_waveforms += kept[station]

        if sum(availability.values()) == 0:
            raise util.DataAvailabilityException

        onsets = np.stack(onsets, axis=0)
        onset_data = OnsetData(
            onsets_dict,
            self.phases,
            self.channel_maps,
            filtered_waveforms,
            availability,
            data.starttime,
            data.endtime,
            self.sampling_rate,
        )

        return onsets, onset_data

    def prepare_device_inputs(self, data, slots, c_max=None, dtype=None):
        """
        Build the fixed-shape channel block for the fully-fused kurtosis
        detect program (ops.scan_window.detect_window_fused_kurtosis).
        Returns (channels [n_slots, C_max, T], chan_mask, slot_mask,
        nkurt, availability dict).

        """

        if c_max is None:
            c_max = max(3, max(self.channel_counts.values()))
        dtype = np.float32 if dtype is None else dtype

        t_len = util.time2sample(
            data.endtime - data.starttime, self.sampling_rate
        ) + 1

        n_slots = len(slots)
        channels = np.zeros((n_slots, c_max, t_len), dtype=dtype)
        chan_mask = np.zeros((n_slots, c_max), dtype=dtype)
        slot_mask = np.zeros(n_slots, dtype=dtype)
        nkurt = np.full(n_slots, 2, dtype=np.int32)
        availability = {}

        kept_by_phase = {}
        nkurt_by_phase = {}
        for phase in self.phases:
            nkurt_by_phase[phase] = util.time2sample(
                self.kurtosis_windows[phase], self.sampling_rate
            ) + 1
            filtered = pre_process(
                data.waveforms.select(channel=self.channel_maps[phase]),
                self.sampling_rate,
                data.resample,
                data.upfactor,
                self.bandpass_filters[phase],
                data.starttime,
                data.endtime,
            )
            kept, phase_avail = gather_phase_waveforms(
                self, data, phase, filtered
            )
            availability.update(phase_avail)
            kept_by_phase[phase] = kept

        for s, (phase, station) in enumerate(slots):
            nkurt[s] = nkurt_by_phase[phase]
            waveforms = kept_by_phase[phase].get(station)
            if waveforms is None:
                continue
            traces = list(waveforms)[:c_max]
            for c, tr in enumerate(traces):
                row = np.asarray(tr.data, dtype=dtype)
                channels[s, c, : len(row)] = row[:t_len]
                chan_mask[s, c] = 1.0
            slot_mask[s] = 1.0

        return channels, chan_mask, slot_mask, nkurt, availability

    def fused_static_args(self, timespan):
        """Static args for detect_window_fused_kurtosis: (nsmooth,
        taper_pad, min_onset_value)."""

        nsmooth = max(
            1, util.time2sample(self.smoothing_window, self.sampling_rate)
        )
        pre_pad, _ = self.pad(timespan)
        taper_pad = util.time2sample(
            pre_pad - self.pre_pad, self.sampling_rate
        )
        return nsmooth, taper_pad, float(self.min_onset_value)

    def _combine(self, onsets, nkurt, timespan):
        """RMS-combine one station's characteristic-function rows."""

        onsets = onsets.copy()
        if timespan:
            pre_pad, _ = self.pad(timespan)
            taper_pad = util.time2sample(
                pre_pad - self.pre_pad, self.sampling_rate
            )
            onsets[:, : taper_pad + nkurt - 1] = 1.0
            onsets[:, -max(taper_pad, 1):] = 1.0

        onset = np.sqrt(np.sum(onsets**2, axis=0) / len(onsets))
        return np.clip(onset, self.min_onset_value, np.inf)

    def gaussian_halfwidth(self, phase):
        """Half the kurtosis window, in samples."""

        return self.kurtosis_windows[phase] * self.sampling_rate / 2

    @property
    def pre_pad(self):
        """3x the longest kurtosis window."""

        return 3 * max(self.kurtosis_windows.values())

    @pre_pad.setter
    def pre_pad(self, value):
        self._pre_pad = value

    @property
    def post_pad(self):
        return self._post_pad

    @post_pad.setter
    def post_pad(self, ttmax):
        kurt_max = max(self.kurtosis_windows.values())
        self._post_pad = np.ceil(ttmax + 2 * kurt_max)
