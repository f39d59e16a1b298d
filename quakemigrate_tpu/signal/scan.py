# -*- coding: utf-8 -*-
"""
QuakeScan: the detect() and locate() stages.

Architecture (accelerator-first redesign of
quakemigrate/signal/scan.py:45-1145):

- The traveltime table is uploaded to the device ONCE per run as a
  node-major int32 array with one column per canonical station/phase slot;
  per-timestep availability is a float mask, so the device program never
  recompiles as stations drop in and out (the reference re-stacks the
  table host-side every timestep, scan.py:621).
- detect: each timestep is one fused device call (migrate + per-sample
  max/argmax/sum reduction) -- the 4-D map never touches device memory.
  The host loop is purely the input pipeline (archive reads + onset
  preprocessing) and the .scanmseed writer.
- locate: the same migration retains the (flattened) 4-D map on device,
  which is fetched once per event for marginalisation and location fitting
  (spline / Gaussian / covariance estimators, mirroring
  scan.py:695-1043).
- Compute runs in float32 by default (precision="single"); "double" is
  available for bit-level parity work on CPU.
- An optional device mesh shards the grid-node axis across devices
  (quakemigrate_tpu.parallel).

"""

import logging
import warnings
from datetime import time
from time import perf_counter

import numpy as np
import pandas as pd
from scipy import ndimage

import quakemigrate_tpu.util as util
from quakemigrate_tpu.io import (
    Event,
    Run,
    ScanmSEED,
    read_triggered_events,
    write_availability,
    write_coalescence,
    write_cut_waveforms,
)
from quakemigrate_tpu.ops.migrate import (
    DEFAULT_TILE,
    find_max_coa,
    migrate_detect,
    migrate_map,
)
from quakemigrate_tpu.seis import UTCDateTime
from .onsets import Onset
from .pickers import GaussianPicker, PhasePicker
from .local_mag import LocalMag

warnings.filterwarnings(
    "ignore", message=("Covariance of the parameters could not be estimated")
)


class QuakeScan:
    """
    Detect and locate earthquakes by continuous migration of onset
    functions through a traveltime lookup table.

    Parameters mirror the reference API: archive, lut, onset, run_path,
    run_name plus keyword attributes (timestep, marginal_window, picker,
    mags, plotting/writing toggles). Device-execution additions:

    precision : {"single", "double"}, optional
        Device compute dtype (default "single" = float32).
    mesh : jax.sharding.Mesh, optional
        Shard the grid-node axis over this device mesh.
    tile : int, optional
        Node-tile size of the XLA migration programs (locate's map and
        marginalisation; detect in float64 or on a CPU host).

    """

    _OPTION_DEFAULTS = {
        # scan geometry
        "timestep": 120.0,
        "marginal_window": 2.0,
        "threads": 1,  # accepted for API parity; no effect on the device
        # device execution
        "precision": "single",
        "mesh": None,
        "tile": DEFAULT_TILE,
        "detect_batch": 1,
        # Detect drain-pipe depth (batches of dispatched-but-unfetched
        # results). This is the stall budget for transient host-side
        # fetch/append slowdowns: dispatch only blocks once this many
        # batches queue behind a slow fetch. Each queued batch holds only
        # its device result handles plus (start time, availability) per
        # window -- the heavy prepared-window state is dropped at
        # dispatch -- so host memory cost is negligible at any depth.
        "detect_drain_depth": 8,
        # Largest 4-D map (bytes) that locate retains when it must write
        # the map or an event video; larger maps take the two-pass path.
        # The bound is for the HOST: the map is fetched and held there,
        # one event at a time. The device is not the constraint -- on an
        # 80 GB card a 4 GB map and its migration temporaries take a
        # small share of what a JAX process reserves.
        "locate_map_memory_limit": 4e9,
        # Post-processing worker threads for locate: location/uncertainty
        # math, picks, magnitudes and file writes for event i overlap the
        # device migration of events i+1.. (events are independent -- the
        # reference notes the per-event loop is embarrassingly parallel,
        # ref signal/scan.py:496, but runs it serially). 0 = fully serial.
        "locate_workers": 4,
        "fused_detect": True,
        # Persistent XLA compilation cache: True (default location), a
        # directory path, or False. $JAX_COMPILATION_CACHE_DIR, when
        # set, wins over both (util.compilation_cache_dir).
        "compilation_cache": True,
        # plotting
        "plot_event_summary": True,
        "plot_event_video": False,
        "plot_all_stns": True,
        "xy_files": None,
        # file writing
        "continuous_scanmseed_write": False,
        "write_cut_waveforms": False,
        "write_real_waveforms": False,
        "real_waveform_units": "displacement",
        "write_wa_waveforms": False,
        "wa_waveform_units": "displacement",
        "cut_waveform_format": "MSEED",
        "write_marginal_coalescence": False,
        "write_coalescence": False,
    }

    def __init__(self, archive, lut, onset, run_path, run_name, **kwargs):
        self.archive = archive
        self.lut = lut
        if isinstance(onset, Onset):
            self.onset = onset
        else:
            raise util.OnsetTypeError
        self.onset.post_pad = lut.max_traveltime

        self.pre_pad = 0.0
        self.post_pad = 0.0

        self.run = Run(
            run_path,
            run_name,
            kwargs.get("run_subname", ""),
            loglevel=kwargs.get("loglevel", "info"),
        )
        self.log = kwargs.get("log", False)

        picker = kwargs.get("picker")
        if picker is None:
            self.picker = GaussianPicker(onset=onset)
        elif isinstance(picker, PhasePicker):
            self.picker = picker
        else:
            raise util.PickerTypeError

        mags = kwargs.get("mags")
        if mags is not None and not isinstance(mags, LocalMag):
            raise util.MagsTypeError
        self.mags = mags

        # Scan, device-execution, plotting and file-writing options.
        # detect_batch: windows migrated per device call (vmapped; ignored
        #   with a mesh). locate_map_memory_limit: above this map4d size
        #   (bytes) locate switches to the two-pass map-free path.
        # fused_detect: whole detect window as ONE device program
        #   (STALTA/kurtosis onsets, single device).
        for option, default in self._OPTION_DEFAULTS.items():
            setattr(self, option, kwargs.get(option, default))
        self.detect_batch = max(1, int(self.detect_batch))
        self.detect_drain_depth = max(1, int(self.detect_drain_depth))
        self.locate_workers = max(0, int(self.locate_workers))
        if self.compilation_cache:
            util.enable_compilation_cache(
                None if self.compilation_cache is True
                else self.compilation_cache
            )

        self.pre_cut = self.post_cut = None

        # Deprecated parameter names from older reference scripts
        # (reference: signal/scan.py:1099-1145)
        for legacy in ("time_step", "n_cores", "sampling_rate"):
            setattr(self, legacy, kwargs.get(legacy))

        import threading

        self._plot_lock = threading.Lock()

        # Lazily-built device state (per run)
        self._device_tt = None
        self._slot_index = None
        self._sharded_detect = None
        self._sharded_detect_key = None
        self._sharded_marginalise = None
        self._sharded_marginalise_key = None
        self._sharded_detect_fused = None
        self._sharded_fused_key = None

    def __str__(self):
        out = (
            "\tScan parameters:\n"
            f"\t\tScan sampling rate = {self.scan_rate} Hz\n"
            f"\t\tDevice precision   = {self.precision}\n"
        )
        if self.run.stage == "detect":
            out += f"\t\tTime step          = {self.timestep} s\n"
        elif self.run.stage == "locate":
            out += f"\t\tMarginal window    = {self.marginal_window} s\n"

        return out

    @property
    def scan_rate(self):
        """Scan sampling rate: fixed to the onset sampling rate (the
        traveltime quantisation and window geometry depend on it)."""

        return self.onset.sampling_rate

    @scan_rate.setter
    def scan_rate(self, value):
        # Reference parity (ref scan.py:1080-1097): refuse silently
        # breaking the traveltime quantisation via a user assignment.
        if value != self.onset.sampling_rate:
            print(
                "Warning: scan sampling rate is fixed to the onset "
                f"sampling rate ({self.onset.sampling_rate} Hz); "
                f"ignoring {value}."
            )

    # ------------------------------------------------------------------
    # Device state
    # ------------------------------------------------------------------

    @property
    def _dtype(self):
        return np.float64 if self.precision == "double" else np.float32

    def _canonical_slots(self):
        """Phase-major (phase, station) slot ordering for the onset block."""

        stations = list(self.archive.stations)
        return [
            (phase, station)
            for phase in self.onset.phases
            for station in stations
        ]

    def _build_device_state(self):
        """
        Stack the full traveltime table into a node-major int32 array with
        one column per canonical slot, and upload it once.

        """

        import jax

        slots = self._canonical_slots()
        self._slot_index = {
            f"{station}_{phase}": i for i, (phase, station) in enumerate(slots)
        }
        tables = []
        for phase, station in slots:
            try:
                tables.append(self.lut[station][phase])
            except (KeyError, TypeError):
                raise util.LUTPhasesException(
                    f"Attempting to migrate phase {phase} for station "
                    f"{station}; traveltimes not found in the LUT. Please "
                    f"create a new lookup table with phases="
                    f"{self.onset.phases}."
                )
        tt = np.stack(
            [np.rint(t * self.scan_rate).astype(np.int32).ravel() for t in tables],
            axis=-1,
        )  # [n_nodes, n_slots]

        if self.mesh is None:
            self._device_tt = jax.device_put(tt)
        else:
            # Each device of the mesh holds its own slab of the table (and
            # a copy per "batch" row); nothing is staged on one device.
            from jax.sharding import NamedSharding, PartitionSpec

            from quakemigrate_tpu.parallel import pad_nodes_for_mesh

            n_shards = self.mesh.shape["grid"]
            tt, _ = pad_nodes_for_mesh(tt, n_shards, tile=self.tile)
            self._device_tt = jax.device_put(
                tt, NamedSharding(self.mesh, PartitionSpec("grid", None))
            )
        self._n_nodes = int(np.prod(self.lut.node_count))

    def _build_sharded_detect_fused(self, kind, fsmp, nsamples):
        """Build the mesh-sharded fused detect window (STA/LTA or
        kurtosis onsets)."""

        from quakemigrate_tpu.parallel import (
            make_sharded_detect_fused,
            make_sharded_detect_fused_kurtosis,
        )

        batch_axis = "batch" if self._mesh_batch_size() else None
        self._sharded_fused_extra = (self._device_tt,)
        if kind == "kurtosis":
            nsmooth, taper_pad, min_onset = (
                self.onset.fused_static_args(self.timestep)
            )
            self._sharded_detect_fused = make_sharded_detect_fused_kurtosis(
                self.mesh, nsmooth, taper_pad, min_onset,
                fsmp, nsamples, self._n_nodes, tile=self.tile,
                batch_axis=batch_axis,
            )
        else:
            self._sharded_detect_fused = make_sharded_detect_fused(
                self.mesh,
                self.onset.position,
                self.onset.signal_transform,
                float(self.onset.min_onset_value),
                fsmp, nsamples, self._n_nodes, tile=self.tile,
                batch_axis=batch_axis,
            )

    def _device_inputs(self, onsets, onset_data):
        """
        Scatter the computed onsets into the fixed canonical slot layout
        and build the availability mask.

        """

        n_slots = len(self._slot_index)
        t_len = onsets.shape[-1]
        block = np.ones((n_slots, t_len), dtype=self._dtype)
        mask = np.zeros(n_slots, dtype=self._dtype)

        for station, phase_onsets in onset_data.onsets.items():
            for phase, onset in phase_onsets.items():
                slot = self._slot_index[f"{station}_{phase}"]
                block[slot] = onset
                mask[slot] = 1.0

        available = float(mask.sum())
        return block, mask, available

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def detect(self, starttime, endtime, resume=False):
        """
        Continuous coalescence scan between two timestamps, writing the
        .scanmseed stream and station availability tables.

        With ``resume=True``, any whole timesteps already present in the
        run's .scanmseed output are skipped: the scan fast-forwards to the
        first missing timestep (on the original timestep grid) and appends
        to the partially written day. Availability tables merge with
        existing rows, so a crashed multi-day scan restarts where it died.

        """

        self.run.stage = "detect"
        self.run.logger(self.log)

        starttime, endtime = UTCDateTime(starttime), UTCDateTime(endtime)
        if starttime >= endtime:
            # equal times would yield a zero-step scan and an empty
            # scanmseed write -- reject up front like a reversed span
            raise util.TimeSpanException
        if endtime.time == time(0, 0):
            endtime = endtime - 1 / self.scan_rate

        seed_stream = None
        if resume:
            starttime, seed_stream = self._detect_resume_state(
                starttime, endtime
            )
            if starttime is None:
                logging.info(
                    "\tNothing to resume: the requested span is already "
                    "fully scanned."
                )
                return
            logging.info(f"\tResuming detect from {starttime}.")

        n_steps = int(np.ceil((endtime - starttime) / self.timestep))

        calc_endtime = starttime + n_steps * self.timestep - 1 / self.scan_rate
        if calc_endtime - endtime > 1 / self.scan_rate:
            logging.info(
                f"Warning: chosen run duration {endtime - starttime} s is "
                f"not divisible by the specified timestep {self.timestep} s. "
                f"Detect will instead compute up to {calc_endtime}\n"
            )

        details = [f"\n\tScanning from {starttime} to {calc_endtime}\n",
                   self, str(self.onset)]
        if self._fused_active:
            where = ("sharded over the device mesh" if self.mesh is not None
                     else "on one device")
            details.append(
                f"\tDevice program: fully-fused detect window ({where})\n"
            )
        elif self.fused_detect:
            details.append(
                "\tDevice program: standard migrate (the fused window "
                "covers the STALTA and kurtosis onsets)\n"
            )
        self._announce("\tDETECT - Continuous coalescence scan", details)

        # Per-batch loop intervals (n_windows, seconds), populated by
        # _detect_loop. Benchmarks read this to report percentile
        # throughput: transient slow episodes can drag a whole-day mean
        # while the median is healthy.
        # detect_batch_attrib carries the per-batch attribution (read_wait /
        # prepare / dispatch / drain_wait seconds on the main thread) and
        # detect_drain_marks the drain worker's per-batch device-fetch and
        # scanmseed-append seconds, so a slow mean is attributable to a
        # stage instead of guessed at (round-4 review finding).
        self.detect_batch_marks = []
        self.detect_batch_attrib = []
        self.detect_drain_marks = []

        self._continuous_compute(starttime, n_steps, seed_stream)

        logging.info(util.log_spacer)

    def _detect_resume_state(self, starttime, endtime):
        """
        (new_starttime, seed_stream) for a resumed detect: fast-forward past
        whole timesteps already on disk, and preload the partially written
        day's stream so appends don't clobber it. (None, None) when the
        whole span is already scanned.

        """

        from quakemigrate_tpu.seis import Stream, read

        outdir = self.run.path / "detect" / "scanmseed"
        delta = 1.0 / self.scan_rate

        # Walk the days forward and require CONTIGUOUS coverage from
        # starttime: a day file left by an unrelated earlier run (or one
        # preceded by an unscanned gap) must not fast-forward past work
        # that was never done.
        covered_to = starttime
        last_stream = None
        day = UTCDateTime(starttime.date)
        while day <= endtime:
            candidate = outdir / f"{day.year}_{day.julday:03d}.scanmseed"
            if not candidate.is_file():
                break
            try:
                on_disk = read(str(candidate))
                coa = on_disk.select(station="COA")[0]
            except Exception:
                # A crash mid-write can leave a truncated/empty day file
                # -- exactly the state resume exists to recover from.
                logging.info(
                    f"\tResume: unreadable partial file {candidate}; "
                    f"rescanning from {covered_to}."
                )
                break
            if coa.stats.starttime > covered_to:
                break  # gap before this file: not this run's coverage
            if coa.stats.endtime + delta <= covered_to:
                break  # file ends before the requested span begins
            covered_to = coa.stats.endtime + delta
            last_stream = on_disk
            day = day + 86400

        done_steps = int(
            np.floor((covered_to - starttime) / self.timestep + 1e-9)
        )
        if done_steps <= 0:
            return starttime, None
        new_start = starttime + done_steps * self.timestep
        if new_start > endtime:
            return None, None

        # Only seed when we will append into the same (partial) day, and
        # trim the seed to the whole-timestep boundary: the recomputed
        # partial step may differ by a count from the crashed run's
        # values, and ScanmSEED's merge refuses conflicting overlaps.
        seed = None
        if (last_stream is not None
                and new_start.date == last_stream[0].stats.starttime.date):
            seed = Stream()
            for tr in last_stream:
                seed += tr
            seed.trim(endtime=new_start - delta)
        return new_start, seed

    def locate(self, starttime=None, endtime=None, trigger_file=None):
        """
        Re-migrate short windows around triggered events on the full grid;
        compute locations, uncertainties, picks and magnitudes.

        """

        self.run.stage = "locate"
        self.run.logger(self.log)

        if trigger_file is None and starttime is None and endtime is None:
            raise RuntimeError("Must supply an input argument.")
        if (starttime is None) ^ (endtime is None):
            raise RuntimeError("Must supply a starttime AND an endtime.")
        if starttime is not None:
            starttime, endtime = UTCDateTime(starttime), UTCDateTime(endtime)
            if starttime > endtime:
                raise util.TimeSpanException

        if trigger_file is not None:
            span = f"\n\tLocating events in {trigger_file}"
        else:
            span = f"\n\tLocating events from {starttime} to {endtime}\n"
        details = [span, self, str(self.onset), str(self.picker)]
        if self.mags is not None:
            details += [self.archive.__str__(response_only=True),
                        str(self.mags)]
        self._announce(
            "\tLOCATE - Determining event location and uncertainty", details
        )

        if trigger_file is not None:
            self._locate_events(trigger_file=trigger_file)
        else:
            self._locate_events(starttime=starttime, endtime=endtime)

        logging.info(util.log_spacer)

    @staticmethod
    def _announce(title, details):
        """Stage banner: spacer / title / spacer / details / spacer."""

        for line in (util.log_spacer, title, util.log_spacer, *details,
                     util.log_spacer):
            logging.info(line)

    # ------------------------------------------------------------------
    # detect internals
    # ------------------------------------------------------------------

    def _continuous_compute(self, starttime, n_steps, seed_stream=None):
        from concurrent.futures import ThreadPoolExecutor

        coalescence = ScanmSEED(
            self.run, self.continuous_scanmseed_write, self.scan_rate
        )
        if seed_stream is not None:
            # Resumed mid-day: carry the already-written part of the day so
            # the day-file write includes it.
            coalescence.stream = seed_stream

        self.pre_pad, self.post_pad = self.onset.pad(self.timestep)
        availability_cols = [
            f"{stat}_{ph}"
            for ph in self.onset.phases
            for stat in self.archive.stations
        ]
        availability = {}

        def window(i):
            w_beg = starttime + self.timestep * i - self.pre_pad
            w_end = (
                starttime
                + self.timestep * (i + 1)
                - 1 / self.scan_rate
                + self.post_pad
            )
            return w_beg, w_end

        # Archive reads double-buffer against device compute: windows are
        # fetched on a worker thread while the previous batch migrates.
        # Result draining (device wait + host fetch + scanmseed append)
        # runs on its own single worker so the main thread's
        # read/prepare/dispatch, the device compute, and the result fetch
        # pipeline as three overlapping stages; the single worker keeps
        # appends chronological.
        reader = ThreadPoolExecutor(max_workers=1)
        drainer = ThreadPoolExecutor(max_workers=1)
        batch_size = self._detect_batch_size()
        reads = {
            i: reader.submit(self.archive.read_waveform_data, *window(i))
            for i in range(min(2 * batch_size, n_steps))
        }
        drains = []  # submitted-but-unfinished drain futures

        try:
            self._detect_loop(
                reader, drainer, reads, drains, coalescence, availability,
                availability_cols, starttime, n_steps, batch_size, window,
            )
        finally:
            # On failure paths too: stop the worker threads fetching
            # archive data / device results behind the traceback.
            reader.shutdown(wait=False, cancel_futures=True)
            drainer.shutdown(wait=False, cancel_futures=True)

        if not coalescence.written:
            coalescence.write()
        availability_df = pd.DataFrame.from_dict(
            availability, orient="index", columns=availability_cols
        ).fillna(0).astype(int)
        write_availability(self.run, availability_df)

    def _mesh_batch_size(self):
        """
        Fixed window-batch size for the fused batch x grid mesh path, or
        None when no mesh batch axis exists. Rounded up to a whole
        multiple of the mesh's batch extent so windows shard evenly
        (inert pad windows fill the remainder); at least one window per
        batch shard, so a 2-D mesh batches windows even at the default
        detect_batch=1.

        """

        if self.mesh is None or "batch" not in self.mesh.axis_names:
            return None
        nb = self.mesh.shape["batch"]
        return -(-max(self.detect_batch, nb) // nb) * nb

    def _detect_batch_size(self):
        """Windows per detect dispatch: detect_batch on one device; under
        a mesh, 1 unless the mesh has a "batch" axis (then the rounded
        window batch shards over it)."""

        if self.mesh is None:
            return self.detect_batch
        return self._mesh_batch_size() or 1

    def _detect_loop(self, reader, drainer, reads, drains, coalescence,
                     availability, availability_cols, starttime, n_steps,
                     batch_size, window):
        """The continuous-detect batch loop (split out so the caller can
        guarantee executor shutdown on every exit path)."""

        def submit_drain(prepared, results):
            # Hand the drain only what it consumes (window start time and
            # the availability row) -- holding the full prepared dicts
            # (raw waveforms + onset/channel blocks) across a
            # detect_drain_depth-deep pipe would pin ~depth x batch_size
            # windows of host memory for no reader.
            slim = {
                i: (p["data"].starttime, p["onset_data"].availability)
                for i, p in prepared.items()
            }
            drains.append(drainer.submit(
                self._drain_detect_results, coalescence, availability,
                starttime, slim, results,
            ))

        def join_drains():
            # Propagates the first drain exception, in submission order.
            while drains:
                drains.pop(0).result()

        marks = getattr(self, "detect_batch_marks", None)
        attrib = getattr(self, "detect_batch_attrib", None)
        t_mark = perf_counter()
        for batch_start in range(0, n_steps, batch_size):
            steps = list(range(batch_start, min(batch_start + batch_size,
                                                n_steps)))
            # Keep the prefetch queue two batches deep
            for j in range(batch_start + batch_size,
                           min(batch_start + 2 * batch_size, n_steps)):
                if j not in reads:
                    reads[j] = reader.submit(
                        self.archive.read_waveform_data, *window(j)
                    )

            t_read = t_prep = t_disp = t_back = 0.0
            prepared = {}
            for i in steps:
                w_beg, w_end = window(i)
                logging.info(
                    (
                        f" Processing : {w_beg + self.pre_pad}-"
                        f"{w_end - self.post_pad} "
                    ).center(110, "~")
                )
                try:
                    t0 = perf_counter()
                    data = reads.pop(i).result()
                    t1 = perf_counter()
                    t_read += t1 - t0
                    prepared[i] = self._prepare_window(data)
                    t_prep += perf_counter() - t1
                except (
                    util.ArchiveEmptyException,
                    util.DataGapException,
                    util.DataAvailabilityException,
                ) as e:
                    # Keep the output stream chronological: dispatch any
                    # already-prepared earlier steps of THIS batch, then
                    # wait out the drain queue before writing the empty
                    # block.
                    if prepared:
                        submit_drain(prepared, self._run_detect_batch(prepared))
                        prepared = {}
                    join_drains()
                    step_label = str(starttime + self.timestep * i)
                    coalescence.empty(
                        starttime, self.timestep, i, e.msg,
                        self.lut.unit_conversion_factor,
                    )
                    availability[step_label] = dict.fromkeys(
                        availability_cols, 0
                    )

            # Dispatch this batch's (async) device calls and hand the
            # results straight to the drain worker -- the fetch (device
            # wait + transfer + scanmseed append) proceeds there
            # while this thread moves on to the next batch's archive read
            # and onset preprocessing, and the device computes the batch
            # just dispatched.
            if prepared:
                t0 = perf_counter()
                results = self._run_detect_batch(prepared)
                for r in results.values():
                    # Start the device->host copy now; the drain then
                    # finds (some of) the data already local. The batched
                    # path hands back a tuple of three arrays per window.
                    for part in (r if isinstance(r, tuple) else (r,)):
                        if hasattr(part, "copy_to_host_async"):
                            part.copy_to_host_async()
                submit_drain(prepared, results)
                t_disp = perf_counter() - t0
            # Backpressure: bound the drain pipe so device-queue depth and
            # host buffering stay bounded. The depth (detect_drain_depth,
            # default 8 batches) is the stall budget: a slow fetch or
            # append blocks dispatch only after this many batches pile up
            # behind it.
            t0 = perf_counter()
            while len(drains) > self.detect_drain_depth:
                drains.pop(0).result()
            if batch_start + batch_size >= n_steps:
                join_drains()
            t_back = perf_counter() - t0
            now = perf_counter()
            if marks is not None:
                marks.append((len(steps), now - t_mark))
            if attrib is not None:
                attrib.append({
                    "n": len(steps), "total": now - t_mark,
                    "read_wait": t_read, "prepare": t_prep,
                    "dispatch": t_disp, "drain_wait": t_back,
                })
            t_mark = now

    def _drain_detect_results(self, coalescence, availability, starttime,
                              slim, results):
        """Fetch one batch's device results and write them out, in order.
        ``slim`` maps step index -> (window start time, availability row)
        -- the only prepared-window state the drain consumes."""

        from quakemigrate_tpu.ops.scan_window import unpack_detect_window

        drain_marks = getattr(self, "detect_drain_marks", None)
        t_fetch = t_append = 0.0
        for i in sorted(slim):
            step_label = str(starttime + self.timestep * i)
            win_start, avail_row = slim[i]
            t0 = perf_counter()
            if isinstance(results[i], tuple):  # batched path: three arrays
                max_coa, max_coa_n, max_idx = (
                    np.asarray(a) for a in results[i]
                )
            else:  # per-window dispatch: one packed fetch per window
                max_coa, max_coa_n, max_idx = unpack_detect_window(results[i])
            t1 = perf_counter()
            t_fetch += t1 - t0
            coord = self.lut.index2coord(max_idx, unravel=True)
            coalescence.append(
                win_start + self.pre_pad,
                np.asarray(max_coa, dtype=np.float64),
                np.asarray(max_coa_n, dtype=np.float64),
                coord,
                self.lut.unit_conversion_factor,
            )
            availability[step_label] = avail_row
            t_append += perf_counter() - t1
        if drain_marks is not None:
            drain_marks.append({
                "n": len(slim), "fetch": t_fetch, "append": t_append,
            })

    # ------------------------------------------------------------------
    # locate internals
    # ------------------------------------------------------------------

    def _locate_events(self, **kwargs):
        from concurrent.futures import ThreadPoolExecutor

        candidates = read_triggered_events(self.run, **kwargs)
        total = len(candidates.index)

        self.pre_pad, self.post_pad = self.onset.pad(4 * self.marginal_window)

        # Archive reads for the next event overlap the current event's
        # compute/picking/plotting (events are independent; the reader
        # thread only touches the read-only Archive).
        reader = ThreadPoolExecutor(max_workers=1)
        events = [Event(self.marginal_window, row)
                  for _, row in candidates.iterrows()]
        pending = {}

        def submit_read(j):
            if 0 <= j < len(events) and j not in pending:
                half_span = 2 * self.marginal_window
                w_beg = events[j].trigger_time - half_span - self.pre_pad
                w_end = events[j].trigger_time + half_span + self.post_pad
                pending[j] = reader.submit(
                    self._read_event_waveform_data, w_beg, w_end
                )

        n_workers = max(0, int(self.locate_workers))
        post = (ThreadPoolExecutor(max_workers=n_workers)
                if n_workers else None)
        finishes = []  # submitted-but-unjoined post-processing futures

        # Per-event dispatch intervals; benchmarks (tools/day_locate.py)
        # read this for percentile seconds/event (same rationale as
        # detect_batch_marks: slow episodes drag the mean).
        self.locate_event_marks = []
        t_mark = perf_counter()

        try:
            submit_read(0)
            for i, event in enumerate(events):
                submit_read(i + 1)
                logging.info(util.log_spacer)
                logging.info(f"\tEVENT - {i + 1} of {total} - {event.uid}")
                logging.info(util.log_spacer)
                ok, coa_handle = self._locate_prepare(event, pending.pop(i))
                if not ok:
                    continue
                if post is None:
                    self._locate_finish(event, coa_handle)
                    logging.info(util.log_spacer)
                else:
                    # Backpressure: the device dispatch loop must not run
                    # unboundedly ahead of the post-processing pool (host
                    # memory holds each in-flight event's waveforms + map).
                    # Events that RETAIN their 4-D map (write_coalescence /
                    # event video) can each hold up to
                    # locate_map_memory_limit bytes, so at most one of
                    # those may be in flight -- a 2*workers queue of them
                    # would multiply the serial path's peak memory ~10x.
                    if event.map4d is not None:
                        while finishes:
                            finishes.pop(0).result()
                    finishes.append(
                        post.submit(self._locate_finish, event, coa_handle)
                    )
                    while len(finishes) > (
                        1 if event.map4d is not None else 2 * n_workers
                    ):
                        finishes.pop(0).result()
                now = perf_counter()
                self.locate_event_marks.append(now - t_mark)
                t_mark = now
            while finishes:
                finishes.pop(0).result()
        finally:
            reader.shutdown(wait=False, cancel_futures=True)
            if post is not None:
                post.shutdown(wait=True, cancel_futures=True)

    def _locate_prepare(self, event, waveform_read):
        """
        Device-facing stage of one candidate (runs on the main thread):
        waveform read, migration, marginal-window gate, trim, and the
        async dispatch of the marginalisation pass. Returns
        ``(ok, coa_handle)`` -- ``coa_handle`` is the in-flight device
        array (two-pass path) or None (map4d retained / dropped event).

        """

        try:
            logging.info("\tReading waveform data...")
            event.add_waveform_data(waveform_read.result())
            logging.info("\tComputing 4-D coalescence function...")
            event.add_compute_output(*self._compute(event.data, event))
        except (
            util.ArchiveEmptyException,
            util.DataGapException,
            util.DataAvailabilityException,
        ) as e:
            logging.info(e.msg)
            return False, None

        if self.write_coalescence:
            if event.map4d is not None:
                logging.info("\tSaving full coalescence map...")
                write_coalescence(self.run, event.map4d, event)
            else:
                logging.info(
                    "\tmap4d not retained (two-pass locate); raise "
                    "locate_map_memory_limit to write the full map."
                )

        if not event.in_marginal_window():
            return False, None
        event.trim2window()
        return True, self._dispatch_marginalise(event)

    def _dispatch_marginalise(self, event):
        """
        Start the on-device marginalisation for a trimmed two-pass event
        and its device->host copy; returns the in-flight device array
        (None on the map4d-retaining path, which marginalises host-side).

        """

        if event.map4d is not None:
            return None

        onset_block, mask, available, fsmp, nsamples = (
            event._marginalise_inputs
        )
        i0, i1 = event.trim_bounds
        if self.mesh is not None:
            # Each device marginalises its own node slab (no collective);
            # drop the mesh-padding tail rows on the way out.
            if self._sharded_marginalise_key != (fsmp, nsamples, self.tile):
                from quakemigrate_tpu.parallel import make_sharded_marginalise

                self._sharded_marginalise = make_sharded_marginalise(
                    self.mesh, fsmp, nsamples, tile=self.tile
                )
                self._sharded_marginalise_key = (fsmp, nsamples, self.tile)
            coa_flat = self._sharded_marginalise(
                onset_block, self._device_tt, mask, available, i0, i1 - i0
            )[: self._n_nodes]
        else:
            from quakemigrate_tpu.ops.migrate import migrate_marginalise

            coa_flat = migrate_marginalise(
                onset_block, self._device_tt[: self._n_nodes], mask,
                available, fsmp, nsamples, i0, i1 - i0, tile=self.tile,
            )
        if hasattr(coa_flat, "copy_to_host_async"):
            coa_flat.copy_to_host_async()
        return coa_flat

    def _locate_finish(self, event, coa_handle):
        """
        Host post-processing of one migrated candidate: location and
        uncertainty estimation, picks, magnitudes, output files and
        figures. Runs on a ``locate_workers`` pool thread (or inline when
        locate_workers=0); everything here is per-event host math plus
        the O(n_nodes) fetch of the already-dispatched marginalised map.

        """

        logging.info(f"\t[{event.uid}] Determining event location and "
                     "uncertainty...")
        coa_map = self._calculate_location(event, coa_handle)

        if self.write_marginal_coalescence:
            logging.info(f"\t[{event.uid}] Saving marginalised coalescence "
                         "map...")
            write_coalescence(self.run, coa_map, event, marginalised=True)

        import contextlib

        logging.info(f"\t[{event.uid}] Making phase picks...")
        # matplotlib (pyplot global state) is not thread-safe: when the
        # picker or magnitude stage will plot, serialize that stage
        # across the worker pool with the same lock the event figures
        # hold; plot-free runs stay fully parallel.
        pick_guard = (self._plot_lock if getattr(self.picker, "plot_picks",
                                                 False)
                      else contextlib.nullcontext())
        with pick_guard:
            event, _ = self.picker.pick_phases(event, self.lut, self.run)

        if self.mags is not None:
            logging.info(f"\t[{event.uid}] Calculating magnitude...")
            mag_guard = (self._plot_lock if getattr(self.mags, "plot", False)
                         else contextlib.nullcontext())
            with mag_guard:
                event, _ = self.mags.calc_magnitude(event, self.lut, self.run)

        event.write(self.run, self.lut)
        # matplotlib is not thread-safe; one event plots at a time.
        with self._plot_lock:
            self._write_event_figures(event, coa_map)
        self._write_event_waveforms(event)
        return True

    def _write_event_figures(self, event, coa_map):
        if self.plot_event_summary:
            from quakemigrate_tpu.plot.event import event_summary

            event_summary(
                self.run, event, coa_map, self.lut,
                xy_files=self.xy_files, plot_all_stns=self.plot_all_stns,
            )
        if self.plot_event_video:
            if event.map4d is None:
                logging.info(
                    "\tSkipping event video: map4d was not retained "
                    "(its size exceeds locate_map_memory_limit)."
                )
            else:
                from quakemigrate_tpu.plot.video import event_video

                event_video(self.run, event, self.lut)

    def _write_event_waveforms(self, event):
        flavours = (
            (self.write_cut_waveforms, {}),
            (self.write_real_waveforms,
             dict(waveform_type="real", units=self.real_waveform_units)),
            (self.write_wa_waveforms,
             dict(waveform_type="wa", units=self.wa_waveform_units)),
        )
        for enabled, extras in flavours:
            if enabled:
                write_cut_waveforms(
                    self.run, event, self.cut_waveform_format,
                    pre_cut=self.pre_cut, post_cut=self.post_cut, **extras,
                )

    # ------------------------------------------------------------------
    # The compute core
    # ------------------------------------------------------------------

    @property
    def _fused_active(self):
        from .onsets import KurtosisOnset, STALTAOnset

        return self.fused_detect and type(self.onset) in (
            STALTAOnset, KurtosisOnset,
        )

    def _prepare_window(self, data):
        """Host-side stage of one detect window: onsets + device inputs."""

        import jax

        from .onsets.base import OnsetData

        if self._device_tt is None:
            self._build_device_state()

        if self._fused_active:
            from .onsets import STALTAOnset

            slots = self._canonical_slots()
            with jax.profiler.TraceAnnotation("qm_prepare_channels"):
                *device_inputs, availability = (
                    self.onset.prepare_device_inputs(
                        data, slots, dtype=self._dtype
                    )
                )
            slot_mask = device_inputs[2]
            if slot_mask.sum() == 0:
                raise util.DataAvailabilityException
            onset_data = OnsetData(
                None, self.onset.phases, self.onset.channel_maps, None,
                availability, data.starttime, data.endtime, self.scan_rate,
            )
            kind = (
                "stalta" if type(self.onset) is STALTAOnset else "kurtosis"
            )
            return {
                "data": data,
                "onset_data": onset_data,
                "fused": tuple(device_inputs),
                "fused_kind": kind,
            }

        with jax.profiler.TraceAnnotation("qm_onsets"):
            onsets, onset_data = self.onset.calculate_onsets(data)
        block, mask, available = self._device_inputs(onsets, onset_data)
        return {
            "data": data,
            "onset_data": onset_data,
            "block": block,
            "mask": mask,
            "available": available,
        }

    def _run_detect_batch(self, prepared):
        """
        Migrate a dict of prepared windows in one (vmapped) device call,
        padding to a fixed batch size so shapes stay constant. Returns
        {window index: (max_coa, max_norm_coa, max_idx)}.

        """

        import jax

        from quakemigrate_tpu.ops.migrate import migrate_detect_batch

        keys = sorted(prepared)
        sample = prepared[keys[0]]
        fsmp = util.time2sample(self.pre_pad, self.scan_rate)
        lsmp = util.time2sample(self.post_pad, self.scan_rate)

        from quakemigrate_tpu.ops.scan_window import pack_detect_window

        if "fused" in sample:
            from quakemigrate_tpu.ops.scan_window import (
                detect_window_fused,
                detect_window_fused_kurtosis,
            )

            nsamples = sample["fused"][0].shape[-1] - fsmp - lsmp
            kind = sample["fused_kind"]
            mesh_batch = self._mesh_batch_size()

            if (self.mesh is not None
                    and self._sharded_fused_key
                    != (kind, fsmp, nsamples, self.tile, mesh_batch)):
                self._build_sharded_detect_fused(kind, fsmp, nsamples)
                self._sharded_fused_key = (
                    kind, fsmp, nsamples, self.tile, mesh_batch,
                )

            if self.mesh is not None and mesh_batch:
                return self._run_fused_mesh_batched(
                    prepared, keys, mesh_batch
                )

            results = {}
            with jax.profiler.TraceAnnotation("qm_detect_fused"):
                for i in keys:
                    if self.mesh is not None:
                        out = self._sharded_detect_fused(
                            *prepared[i]["fused"], *self._sharded_fused_extra
                        )
                    elif kind == "kurtosis":
                        channels, chan_mask, slot_mask, nkurt = (
                            prepared[i]["fused"]
                        )
                        nsmooth, taper_pad, min_onset = (
                            self.onset.fused_static_args(self.timestep)
                        )
                        out = detect_window_fused_kurtosis(
                            channels, chan_mask, slot_mask, nkurt,
                            self._device_tt, nsmooth, taper_pad,
                            min_onset, fsmp, nsamples,
                            n_nodes_real=self._n_nodes, tile=self.tile,
                        )
                    else:
                        channels, chan_mask, slot_mask, nsta, nlta = (
                            prepared[i]["fused"]
                        )
                        out = detect_window_fused(
                            channels, chan_mask, slot_mask, nsta, nlta,
                            self._device_tt,
                            self.onset.position,
                            self.onset.signal_transform,
                            float(self.onset.min_onset_value),
                            fsmp, nsamples,
                            n_nodes_real=self._n_nodes, tile=self.tile,
                        )
                    results[i] = pack_detect_window(*out)
            return results

        nsamples = sample["block"].shape[-1] - fsmp - lsmp

        batch_size = 1 if self.mesh is not None else self.detect_batch
        if batch_size == 1:  # incl. every mesh path (non-fused)
            results = {}
            with jax.profiler.TraceAnnotation("qm_migrate_detect"):
                for i in keys:
                    p = prepared[i]
                    results[i] = pack_detect_window(*self._run_detect_kernel(
                        p["block"], p["mask"], p["available"], fsmp, nsamples
                    ))
            return results

        # Pad to the fixed batch size with inert windows (mask 0)
        n_slots, t_len = sample["block"].shape
        blocks = np.ones((batch_size, n_slots, t_len), dtype=self._dtype)
        masks = np.zeros((batch_size, n_slots), dtype=self._dtype)
        avails = np.ones(batch_size, dtype=self._dtype)
        for j, i in enumerate(keys):
            blocks[j] = prepared[i]["block"]
            masks[j] = prepared[i]["mask"]
            avails[j] = prepared[i]["available"]

        with jax.profiler.TraceAnnotation("qm_migrate_detect"):
            max_coa, max_norm, max_idx = migrate_detect_batch(
                blocks, self._device_tt, masks, avails, fsmp, nsamples,
                n_nodes_real=self._n_nodes, tile=self.tile,
            )

        return {
            i: (max_coa[j], max_norm[j], max_idx[j])
            for j, i in enumerate(keys)
        }

    def _run_fused_mesh_batched(self, prepared, keys, mesh_batch):
        """
        Dispatch one batch of fused windows over the 2-D batch x grid mesh
        as a SINGLE device call: channels/chan_mask/slot_mask stack along
        a leading window axis (sharded over "batch"), padded to the fixed
        ``mesh_batch`` size with inert windows (all-ones channels, zero
        masks -- discarded on unpack) so shapes stay constant. The shared
        per-slot window lengths (nsta/nlta or nkurt) come from the first
        window; they are onset-config constants, identical across windows.

        """

        import jax

        first = prepared[keys[0]]["fused"]
        rest = first[3:]
        channels = np.empty((mesh_batch,) + first[0].shape,
                            dtype=first[0].dtype)
        chan_mask = np.empty((mesh_batch,) + first[1].shape,
                             dtype=first[1].dtype)
        slot_mask = np.empty((mesh_batch,) + first[2].shape,
                             dtype=first[2].dtype)
        for j, i in enumerate(keys):
            f = prepared[i]["fused"]
            channels[j], chan_mask[j], slot_mask[j] = f[0], f[1], f[2]
        # Only the inert tail rows need the all-ones/zero-mask fill; a
        # full-array fill would cost an extra pass over ~GB-scale batches
        # on the dispatch hot path.
        channels[len(keys):] = 1.0
        chan_mask[len(keys):] = 0.0
        slot_mask[len(keys):] = 0.0

        with jax.profiler.TraceAnnotation("qm_detect_fused_batched"):
            out = self._sharded_detect_fused(
                channels, chan_mask, slot_mask, *rest,
                *self._sharded_fused_extra,
            )
        return {
            i: (out[0][j], out[1][j], out[2][j])
            for j, i in enumerate(keys)
        }

    @util.timeit("info")
    def _compute(self, data, event=None):
        """
        One locate-window migration: the per-sample reduction outputs plus
        (only when something on the host consumes it) the 4-D map reshaped
        to (nx, ny, nz, nsamples). Detect windows do NOT come through
        here -- they flow through _prepare_window/_run_detect_batch so the
        input pipeline and drain can overlap the device work.

        """

        import jax

        if self._device_tt is None:
            self._build_device_state()

        with jax.profiler.TraceAnnotation("qm_onsets"):
            onsets, onset_data = self.onset.calculate_onsets(data)
        onset_block, mask, available = self._device_inputs(onsets, onset_data)

        fsmp = util.time2sample(self.pre_pad, onset_data.sampling_rate)
        lsmp = util.time2sample(self.post_pad, onset_data.sampling_rate)
        nsamples = onset_block.shape[-1] - fsmp - lsmp

        map_bytes = (
            self._n_nodes * nsamples * np.dtype(self._dtype).itemsize
        )
        # The full 4-D map is materialised on device AND fetched to
        # host only when the user asked to save it: everything else
        # locate needs (argmax traces + the marginalised 3-D map)
        # comes from the two-pass on-device path, which fetches
        # O(n_nodes) bytes instead of O(n_nodes x nsamples) -- at
        # regional grids the map4d fetch alone (hundreds of MB per
        # event over the host link) can dominate the whole locate.
        retain_map = (
            (self.write_coalescence or self.plot_event_video)
            and map_bytes <= self.locate_map_memory_limit
        )
        if retain_map:
            with jax.profiler.TraceAnnotation("qm_migrate_map"):
                map4d_flat = migrate_map(
                    onset_block, self._device_tt[: self._n_nodes], mask,
                    available, fsmp, nsamples, tile=self.tile,
                )
                max_coa, max_coa_n, max_idx = find_max_coa(map4d_flat)
            map4d = np.asarray(map4d_flat).reshape(
                tuple(self.lut.node_count) + (nsamples,)
            )
        else:
            if self.write_coalescence or self.plot_event_video:
                logging.info(
                    f"\t\tmap4d would need {map_bytes / 1e9:.1f} GB > "
                    "locate_map_memory_limit; using two-pass map-free "
                    "locate (no full map / event video will be "
                    "written)."
                )
            with jax.profiler.TraceAnnotation("qm_migrate_detect"):
                max_coa, max_coa_n, max_idx = self._run_detect_kernel(
                    onset_block, mask, available, fsmp, nsamples
                )
            map4d = None
            # Stash inputs for the second (marginalisation) pass
            event._marginalise_inputs = (
                onset_block, mask, available, fsmp, nsamples,
            )
        coord = self.lut.index2coord(np.asarray(max_idx), unravel=True)
        times = event.mw_times(self.scan_rate, count=nsamples)
        return (
            times,
            np.asarray(max_coa, dtype=np.float64),
            np.asarray(max_coa_n, dtype=np.float64),
            coord,
            map4d,
            onset_data,
        )

    def _run_detect_kernel(self, onset_block, mask, available, fsmp, nsamples):
        if self.mesh is None:
            return migrate_detect(
                onset_block, self._device_tt, mask, available, fsmp,
                nsamples, n_nodes_real=self._n_nodes, tile=self.tile,
            )
        # Keyed on the scan geometry: detect and (two-pass) locate share
        # this cache but run different window lengths.
        if self._sharded_detect_key != (fsmp, nsamples, self.tile):
            from quakemigrate_tpu.parallel import make_sharded_detect

            self._sharded_detect = make_sharded_detect(
                self.mesh, fsmp, nsamples, self._n_nodes, tile=self.tile
            )
            self._sharded_detect_key = (fsmp, nsamples, self.tile)
        return self._sharded_detect(onset_block, self._device_tt, mask,
                                    available)

    @util.timeit("info")
    def _read_event_waveform_data(self, w_beg, w_end):
        """Read waveform data for one event, with magnitude pads if needed."""

        pre_pad = post_pad = 0.0

        if self.mags:
            pre_pad, post_pad = self.mags.amp.pad(
                self.marginal_window,
                self.lut.max_traveltime,
                self.lut.fraction_tt,
            )

        if self.pre_cut:
            pre_pad = max(pre_pad, self.pre_cut)
        if self.post_cut:
            post_pad = max(post_pad, self.post_cut)

        pre_pad = max(0.0, pre_pad - self.marginal_window - self.pre_pad)
        post_pad = max(0.0, post_pad - self.marginal_window - self.post_pad)

        return self.archive.read_waveform_data(w_beg, w_end, pre_pad, post_pad)

    # ------------------------------------------------------------------
    # Location estimation (host-side post-processing of the 3-D map)
    # ------------------------------------------------------------------

    @util.timeit("info")
    def _calculate_location(self, event, coa_handle=None):
        """
        Marginalise the 4-D map over time and compute the three location
        estimates: interpolated spline peak, 3-D Gaussian fit, and global
        covariance. ``coa_handle`` is an already-dispatched device
        marginalisation (from ``_dispatch_marginalise``); without one the
        two-pass path dispatches it here.

        """

        if event.map4d is not None:
            coa_map = np.sum(event.map4d, axis=-1)
        else:
            if coa_handle is None:
                coa_handle = self._dispatch_marginalise(event)
            coa_map = np.asarray(coa_handle, dtype=np.float64).reshape(
                tuple(self.lut.node_count)
            )
        coa_map = coa_map / np.nanmax(coa_map)

        event.add_spline_location(self._splineloc(np.copy(coa_map)))

        smoothed_coa_map = self._gaufilt3d(np.copy(coa_map))
        event.add_gaussian_location(*self._gaufit3d(smoothed_coa_map))

        event.add_covariance_location(*self._covfit3d(np.copy(coa_map)))

        return coa_map

    @staticmethod
    def _peak_window(shape, centre, width):
        """(lo, hi) corners of a width^3 box around ``centre``, grid-clipped."""

        half = (width - 1) // 2
        shape, centre = np.asarray(shape), np.asarray(centre)
        lo = np.clip(centre - half, 0, shape)
        hi = np.clip(centre + half + 1, 0, shape)
        return lo, hi

    @util.timeit()
    def _splineloc(self, coa_map, win=5, upscale=10):
        """
        Sub-node location: cubic RBF fit over a win^3 box at the gridded
        peak, evaluated on an ``upscale``-times-finer lattice.

        """

        peak = np.unravel_index(np.nanargmax(coa_map), coa_map.shape)
        lo, hi = self._peak_window(coa_map.shape, peak, win)
        spans = hi - lo

        if not (spans[0] == spans[1] == spans[2]):
            logging.info(
                "\t !!!! Spline error: interpolation window crosses edge of "
                "grid !!!!"
            )
            return self.lut.index2coord([list(peak)])[0]

        box = coa_map[tuple(slice(a, b) for a, b in zip(lo, hi))]

        # Cubic RBF (phi = r^3) fit at the coarse lattice points, evaluated
        # on the upscaled lattice -- the same interpolant scipy's
        # Rbf(function="cubic") builds (ref scan.py:735-841 uses Rbf), but
        # computed directly: the Gram solve is 125x125, and the fine-point
        # distances come from one (M,3)@(3,125) matmul via the
        # |x-c|^2 = |x|^2 + |c|^2 - 2x.c expansion instead of scipy's
        # per-dimension difference tensors (~4x faster at upscale=10;
        # agreement is exact up to fp summation order).
        coarse = np.indices(box.shape, dtype=np.float64).reshape(3, -1).T
        gram_d2 = (
            (coarse[:, None, :] - coarse[None, :, :]) ** 2
        ).sum(-1)
        gram = gram_d2 * np.sqrt(gram_d2)
        values = box.ravel().astype(np.float64)
        try:
            weights = np.linalg.solve(gram, values)
        except np.linalg.LinAlgError:
            weights = np.linalg.lstsq(gram, values, rcond=None)[0]

        fine_axes = [
            np.linspace(0, dim - 1, (dim - 1) * upscale + 1)
            for dim in box.shape
        ]
        fine = np.meshgrid(*fine_axes, indexing="ij")
        pts = np.stack([g.ravel() for g in fine], axis=1)
        d2 = (
            (pts**2).sum(1)[:, None]
            + (coarse**2).sum(1)[None, :]
            - 2.0 * (pts @ coarse.T)
        )
        np.maximum(d2, 0.0, out=d2)
        sampled = ((d2 * np.sqrt(d2)) @ weights).reshape(fine[0].shape)

        refined = (
            np.asarray(np.unravel_index(np.nanargmax(sampled), sampled.shape))
            / upscale
            + lo
        )
        logging.debug("\t\tGridded loc: {}   {}   {}".format(*peak))
        logging.debug("\t\tSpline  loc: {} {} {}".format(*refined))

        drift = np.abs(np.asarray(peak) - refined)
        if (drift > 1).any():
            logging.debug(
                "\tSpline warning: spline location outside grid cell "
                "with maximum coalescence value"
            )
        if (drift > (win - 1) // 2).any():
            logging.info(
                "\t !!!! Spline error: location outside interpolation "
                "window !!!!"
            )
            return self.lut.index2coord([list(peak)])[0]

        return self.lut.index2coord([list(refined)])[0]

    @util.timeit()
    def _gaufit3d(self, coa_map, thresh=0.0, win=7):
        """
        3-D Gaussian fit (a quadratic form in log space) over a win^3 box at
        the peak of the smoothed map; returns (location, 1-sigma errors).

        """

        peak = np.unravel_index(np.nanargmax(coa_map), coa_map.shape)
        in_fit = (coa_map > thresh) & self._mask3d(coa_map.shape, peak, win)
        nodes = np.where(in_fit)

        values = (coa_map - np.nanmean(coa_map)).astype(np.float64)[nodes]
        neg_log = -np.log(np.clip(values, 1e-300, np.inf))

        # Design matrix rows: x², y², z², xy, xz, yz, x, y, z, 1 — offsets
        # are measured from the peak node.
        x, y, z = (idx - c for idx, c in zip(nodes, peak))
        design = np.stack(
            [x * x, y * y, z * z, x * y, x * z, y * z, x, y, z,
             np.ones(x.size)]
        )
        P = np.matmul(neg_log, np.linalg.pinv(design))
        quad, cross, linear = P[:3], P[3:6], P[6:9]

        def symmetric(diagonal, off_scale):
            m = np.diag(diagonal).astype(float)
            m[0, 1] = m[1, 0] = cross[0] * off_scale
            m[0, 2] = m[2, 0] = cross[1] * off_scale
            m[1, 2] = m[2, 1] = cross[2] * off_scale
            return m

        curvature = -symmetric(2 * quad, 1.0)
        offset = np.matmul(np.linalg.inv(curvature), linear)

        eigenvalues, _ = np.linalg.eig(symmetric(quad, 0.5))
        sigmas = np.sqrt(0.5 / np.clip(np.abs(eigenvalues), 1e-10, np.inf)) / 2

        location = self.lut.index2coord([list(offset + peak)])[0]
        return location, sigmas * self.lut.node_spacing

    @util.timeit()
    def _covfit3d(self, coa_map, thresh=0.90, win=None):
        """
        Coalescence-weighted mean position and covariance of the map values
        above ``thresh`` (optionally restricted to a win^3 box at the peak).

        """

        keep = coa_map > thresh
        if win:
            peak = np.unravel_index(np.nanargmax(coa_map), coa_map.shape)
            keep &= self._mask3d(coa_map.shape, peak, win)

        # Only the (typically few) above-threshold nodes enter the moment
        # sums, so index them out instead of sweeping full-grid lattices.
        # NaN map values never pass the > comparison (same exclusions as
        # the old nansum-over-masked-grid form); the float64 cast below
        # upgrades accumulation precision for float32 maps, so those agree
        # with the old formulation to float32 epsilon rather than exactly.
        kept_idx = np.nonzero(keep)
        weights = coa_map[kept_idx].astype(np.float64)
        total = weights.sum()

        positions = [
            idx * spacing
            for idx, spacing in zip(kept_idx, self.lut.node_spacing)
        ]

        mean = [np.sum(weights * axis) / total for axis in positions]
        deviations = [axis - m for axis, m in zip(positions, mean)]

        covariance = np.empty((3, 3))
        for r in range(3):
            for c in range(r, 3):
                covariance[r, c] = covariance[c, r] = (
                    np.sum(weights * deviations[r] * deviations[c]) / total
                )

        location_xyz = self.lut.ll_corner + np.array(mean)
        location = self.lut.coord2grid(location_xyz, inverse=True)[0]
        return location, np.diag(np.sqrt(abs(covariance)))

    @util.timeit()
    def _gaufilt3d(self, map3d, sgm=0.8, shp=None, _radius=12):
        """
        Double Gaussian smoothing (forward + mirrored to cancel the
        even-axis phase shift), normalised to peak 1.

        Numerically identical (fp noise, ~5e-16) to the reference's two
        full-grid-kernel fftconvolves with inter-pass flips (ref
        scan.py:1007-1043), but ~10x faster at production grid sizes:
        the kernel is separable and vanishes beyond ~``_radius`` cells
        (e^-112 at 12 cells for sigma 0.8), so each pass is three
        truncated 1-D convolutions. The flips are absorbed into the
        kernel centring: fftconvolve('same') centres the full-size
        kernel at (n-1)//2, and the old code's flip before the second
        pass moves that to n//2 on even axes -- the per-axis ``origin``
        reproduces both conventions exactly. Zero-padding ('constant')
        matches the linear convolution's implicit padding.

        """

        if shp is None:
            shp = map3d.shape

        kernels = []
        for n, profile in zip(shp, util.gaussian_profiles(shp, sgm)):
            c2 = n - 1  # 2 * (fractional centre index)
            lo = max(0, -(-(c2 - 2 * _radius) // 2))
            hi = min(n, (c2 + 2 * _radius) // 2 + 1)
            kernels.append((profile[lo:hi], lo, n))

        smoothed = map3d
        for centre in ("first", "flipped"):
            for axis, (w, lo, n) in enumerate(kernels):
                full_centre = (n - 1) // 2 if centre == "first" else n // 2
                origin = (full_centre - lo) - len(w) // 2
                smoothed = ndimage.convolve1d(
                    smoothed, w, axis=axis, mode="constant", cval=0.0,
                    origin=origin,
                )
            smoothed = smoothed / np.nanmax(smoothed)

        return smoothed

    @classmethod
    def _mask3d(cls, n, i, window):
        """Boolean mask of a window^3 box around node i in an n-shaped grid."""

        lo, hi = cls._peak_window(n, i, window)
        mask = np.zeros(np.asarray(n), dtype=bool)
        mask[tuple(slice(a, b) for a, b in zip(lo, hi))] = True
        return mask

    # --- deprecated parameter names from older reference scripts ---
    # (reference: signal/scan.py:1099-1145; setters accept-and-warn so old
    # user scripts keep running unchanged)

    def _legacy_name(new_attr, notice, assign=True):
        """Accept-and-warn views of renamed parameters (ref scan.py:1099-1145)."""

        def read(self):
            return getattr(self, new_attr)

        def write(self, value):
            if value is None:
                return
            print(notice.replace("<RATE>", str(getattr(self, "scan_rate", ""))))
            if assign:
                setattr(self, new_attr, value)

        return property(read, write)

    sampling_rate = _legacy_name(
        "scan_rate",
        "Warning: Parameter name has changed - continuing. Currently\n"
        "the scan sampling rate must be the same as the onset sampling\n"
        "rate, which you have set to <RATE> Hz.",
        assign=False,
    )
    time_step = _legacy_name(
        "timestep",
        "FutureWarning: Parameter name has changed - continuing.\n"
        "To remove this message, change:\n"
        "\t'time_step' -> 'timestep'",
    )
    n_cores = _legacy_name(
        "threads",
        "FutureWarning: Parameter name has changed - continuing.\n"
        "To remove this message, change:\n"
        "\t'n_cores' -> 'threads'\n"
        "(Host thread count does not affect the device migration.)",
    )

    del _legacy_name
