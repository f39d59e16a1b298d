# -*- coding: utf-8 -*-
"""
Projection-aware 3-D grids and traveltime lookup tables.

Same capability surface as the reference Grid3D/LUT
(quakemigrate/lut/lut.py:25-943): corner/spacing grid definition with a
coordinate-space <-> grid-space projection pair, per-station-per-phase
traveltime tables, decimation, interpolation, pickling, and integer-sample
serving for the migration kernel. Projections come from
``quakemigrate_tpu.coords`` (no pyproj).

``serve_traveltimes`` keeps the reference's (nx, ny, nz, n_onsets) layout at
the API boundary; the scan engine flattens to the node-major
[n_nodes, n_onsets] layout the migration kernels want.

Pickle layout note: instance attribute names (``_node_count``,
``_node_spacing``, ``ll_corner``, ``traveltimes``, ...) are part of the
on-disk LUT contract — do not rename them.

"""

import copy
import pathlib
import pickle
from itertools import product

import numpy as np
import pandas as pd
from scipy.interpolate import RegularGridInterpolator

from quakemigrate_tpu.coords import Transformer


def _renamed_parameter(old, new):
    """Property factory for deprecated parameter names (ref lut.py:365-396)."""

    def read(self):
        return getattr(self, new)

    def write(self, value):
        if value is None:
            return
        print(
            "FutureWarning: Parameter name has changed - continuing.\n"
            "To remove this message, change:\n"
            f"\t'{old}' -> '{new}'"
        )
        setattr(self, new, value)

    return property(read, write)


class Grid3D:
    """
    Regular 3-D grid: lower-left / upper-right corners given in an input
    coordinate projection, transformed into a Cartesian grid projection, and
    discretised at a fixed node spacing.

    """

    def __init__(self, ll_corner, ur_corner, node_spacing, grid_proj, coord_proj):
        self.grid_proj, self.coord_proj = grid_proj, coord_proj

        self.ll_corner, self.ur_corner = (
            self.coord2grid(corner)[0] for corner in (ll_corner, ur_corner)
        )
        self.node_spacing = node_spacing

        span = self.ur_corner - self.ll_corner
        self.node_count = 1 + np.ceil(span / self.node_spacing)

    # -- coordinate transforms ----------------------------------------------

    def coord2grid(self, value, inverse=False):
        """Input coordinate space <-> grid space (inverse: grid -> coords)."""

        route = (
            (self.grid_proj, self.coord_proj)
            if inverse
            else (self.coord_proj, self.grid_proj)
        )
        components = np.array(value, dtype=float).T
        transformed = Transformer.from_proj(*route).transform(*components)
        return np.column_stack(transformed)

    def index2grid(self, value, inverse=False, unravel=False):
        """Grid indices <-> grid space (inverse: positions -> indices)."""

        value = (
            np.column_stack(np.unravel_index(value, self.node_count))
            if unravel
            else np.array(value)
        )
        if inverse:
            fractional = (value - self.ll_corner) / self.node_spacing
            points = np.vstack(np.rint(fractional).astype(int))
        else:
            points = np.vstack(self.ll_corner + value * self.node_spacing)
        return points.T if points.shape[1] == 1 else points

    def index2coord(self, value, inverse=False, unravel=False):
        """Grid indices <-> input coordinate space (via grid space)."""

        if inverse:
            return self.index2grid(self.coord2grid(value), inverse=True)
        return self.coord2grid(self.index2grid(value, unravel=unravel),
                               inverse=True)

    # -- decimation -----------------------------------------------------------

    def decimate(self, df, inplace=False):
        """
        Thin the traveltime tables by integer factors per axis, recentring so
        the retained nodes sit symmetrically within the original grid.

        Reference-parity quirk (ref lut/lut.py:102-140): the grid corners
        are NOT updated, so when the recentring offset is nonzero (i.e.
        (node_count-1) % df != 0) index2coord still maps index 0 to the
        original ll_corner — node coordinates shift by offset x old
        spacing, exactly as in the reference. Choose node counts with
        (count-1) divisible by the factor to avoid the shift.

        """

        factors = np.array(df, dtype=int)
        kept = 1 + (self.node_count - 1) // factors
        offset = (self.node_count - factors * (kept - 1) - 1) // 2
        window = tuple(slice(o, None, f) for o, f in zip(offset, factors))

        target = self if inplace else copy.deepcopy(self)
        target.node_count = kept
        target.node_spacing = self.node_spacing * factors
        for tables in target.traveltimes.values():
            for phase in tables:
                tables[phase] = tables[phase][window]

        if not inplace:
            return target

    # -- validated grid geometry ----------------------------------------------

    @property
    def node_count(self):
        """Nodes per axis (int32[3])."""

        return self._node_count

    @node_count.setter
    def node_count(self, value):
        counts = np.asarray(value).astype("int32")
        if not (counts > 0).all():
            raise AssertionError("Node count must be greater than [0]")
        self._node_count = counts

    @property
    def node_spacing(self):
        """Node spacing per axis (float64[3]; scalars broadcast)."""

        return self._node_spacing

    @node_spacing.setter
    def node_spacing(self, value):
        spacing = np.asarray(value, dtype="float64")
        if spacing.size == 1:
            spacing = np.full(3, float(spacing))
        if spacing.shape != (3,):
            raise AssertionError("Node spacing must be an nx3 array.")
        if not (spacing > 0).all():
            raise AssertionError("Node spacing must be greater than [0]")
        self._node_spacing = spacing

    @property
    def n_nodes(self):
        """Total node count."""

        return int(np.prod(self.node_count))

    cell_count = _renamed_parameter("cell_count", "node_count")
    cell_size = _renamed_parameter("cell_size", "node_spacing")

    # -- derived geometry -------------------------------------------------------

    @property
    def grid_corners(self):
        """The eight grid corner positions, in grid space."""

        extremes = [(0, top) for top in self.node_count - 1]
        return self.index2grid(list(product(*extremes)))

    def get_grid_extent(self, cells=False):
        """Geographic extent of the grid (node centres, or full cells)."""

        lower, upper = self.grid_corners[0], self.grid_corners[-1]
        if cells is True:
            half = self.node_spacing / 2
            lower, upper = lower - half, upper + half
        return self.coord2grid([lower, upper], inverse=True)

    grid_extent = property(get_grid_extent)

    @property
    def grid_xyz(self):
        """Node positions as three (nx, ny, nz) mesh arrays."""

        shape = self.node_count
        flat_ijk = np.indices(shape).reshape(3, -1).T
        xyz = self.index2grid(flat_ijk)
        return [xyz[:, axis].reshape(shape) for axis in range(3)]

    @property
    def precision(self):
        """Decimal places per axis that resolve one node spacing."""

        zero, one = self.index2coord([[0, 0, 0], [1, 1, 1]])
        return [
            -int(np.format_float_scientific(step).split("e")[1])
            for step in zero - one
        ]

    @property
    def _grid_axis_info(self):
        return self.grid_proj.crs.axis_info[0]

    @property
    def unit_conversion_factor(self):
        """Grid units -> metres multiplier (1 for m, 1000 for km)."""

        return self._grid_axis_info.unit_conversion_factor

    @property
    def unit_name(self):
        """Short unit label of the grid projection."""

        return "km" if self._grid_axis_info.unit_name == "kilometre" else "m"


class LUT(Grid3D):
    """
    A Grid3D carrying per-station-per-phase traveltime tables
    (``lut.traveltimes[station][phase]``, each (nx, ny, nz) seconds), plus
    serving/interpolation utilities for the scan engine.

    """

    def __init__(self, fraction_tt=0.1, lut_file=None, **grid_spec):
        self.station_data = pd.DataFrame()
        self.fraction_tt = fraction_tt
        if grid_spec:
            super().__init__(**grid_spec)
            self.traveltimes, self.phases, self.velocity_model = {}, [], ""
        else:
            self.phases = ["P", "S"]
            if lut_file is not None:
                self.load(lut_file)

    def __str__(self):
        corners = self.coord2grid(self.grid_corners, inverse=True)
        lower, upper = corners[0], corners[-1]
        unit = self.unit_name

        def corner_line(label, c):
            return (
                f"\n\t{label} : {c[1]:10.5f}°N {c[0]:10.5f}°E "
                f"{c[2]:10.3f} {unit}"
            )

        vmodel = str(self.velocity_model).replace("\n", "\n\t")
        return (
            "quakemigrate_tpu traveltime lookup table\nGrid parameters"
            + corner_line("Lower-left corner ", lower)
            + corner_line("Upper-right corner", upper)
            + f"\n\tNumber of nodes    : {self.node_count}"
            + f"\n\tNode spacing       : {self.node_spacing} {unit}"
            + "\n\n"
            + f"\tVelocity model:\n\t{vmodel}"
        )

    # -- serving ---------------------------------------------------------------

    def serve_traveltimes(self, sampling_rate, availability=None):
        """
        Traveltimes as int32 sample offsets, (nx, ny, nz, n_onsets). With an
        availability dict ("station_phase" -> 0/1) only available onsets are
        stacked, in dict order.

        """

        if availability is None:
            stacked = self._stack_tables(self.phases)
        else:
            # rsplit: station names may themselves contain underscores
            live = [
                key.rsplit("_", 1)
                for key, up in availability.items() if up == 1
            ]
            stacked = np.stack(
                [self[station][phase] for station, phase in live], axis=-1
            )
        return np.rint(stacked * sampling_rate).astype(np.int32)

    def _stack_tables(self, phases, stations=None):
        """Stack (phase-major, then station) tables along a new last axis."""

        if stations is None:
            stations = self.station_data["Name"].values
        return np.stack(
            [self[station][phase] for phase in phases for station in stations],
            axis=-1,
        )

    def traveltime_to(self, phase, ijk, station=None):
        """Traveltime(s) to a fractional grid-index position, interpolated."""

        if station is None:
            tables = self._stack_tables([phase])
        else:
            names = [station] if isinstance(station, str) else station
            tables = self._stack_tables([phase], names)

        axes = tuple(np.arange(n) for n in self.node_count)
        sampler = RegularGridInterpolator(
            axes, tables, bounds_error=False, fill_value=None
        )
        return sampler(ijk)[0]

    @property
    def max_traveltime(self):
        """Largest traveltime in any served table."""

        return np.max(self._stack_tables(self.phases))

    # -- persistence -------------------------------------------------------------

    def save(self, filename):
        """Pickle this LUT's state."""

        path = pathlib.Path(filename)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("wb") as f:
            pickle.dump(self.__dict__, f, 4)

    def load(self, filename):
        """Restore state from a pickled LUT."""

        with open(filename, "rb") as f:
            self.__dict__.update(pickle.load(f))

    # -- network geometry -----------------------------------------------------------

    @property
    def station_extent(self):
        """[[min lon, lat, elev], [max lon, lat, elev]] over the network."""

        positions = self.station_data[["Longitude", "Latitude", "Elevation"]].values
        return [list(positions.min(axis=0)), list(positions.max(axis=0))]

    @property
    def stations_xyz(self):
        """Station positions in grid space."""

        return self.coord2grid(
            self.station_data[["Longitude", "Latitude", "Elevation"]].values
        )

    @property
    def max_extent(self):
        """Union of station and (cell-padded) grid extents, padded 5%."""

        corners = np.array([self.station_extent,
                            self.get_grid_extent(cells=True)])
        lower = corners[:, 0].min(axis=0)
        upper = corners[:, 1].max(axis=0)
        margin = 0.05 * np.abs(upper - lower)
        return np.array([lower - margin, upper + margin])

    # -- misc ---------------------------------------------------------------------

    def plot(self, fig, gs, slices=None, hypocentre=None, station_clr="k",
             station_list=None):
        """Grid cross-section figure with stations (see plot.lut)."""

        from quakemigrate_tpu.plot.lut import lut_plot

        lut_plot(self, fig, gs, slices, hypocentre, station_clr, station_list)

    def __add__(self, other):
        """Merge traveltime tables from a grid-compatible LUT."""

        if not isinstance(other, LUT):
            print("Addition not defined for non-LUT object.")
        elif self == other:
            self.traveltimes.update(other.traveltimes)
        else:
            print("Grid definitions do not match - cannot combine.")
            return None
        return self

    def __eq__(self, other):
        """Grid-definition equality (corners, spacing, projections)."""

        if not isinstance(other, LUT):
            print("Equality of LUT with non-LUT object is undefined.")
            return False
        same_geometry = (
            (self.grid_corners == other.grid_corners).all()
            and (self.node_spacing == other.node_spacing).all()
        )
        same_projections = (
            self.grid_proj == other.grid_proj
            and self.coord_proj == other.coord_proj
        )
        return bool(same_geometry and same_projections)

    def __getitem__(self, key):
        """``lut[station]`` -> that station's phase-keyed traveltime tables."""

        tables = self.traveltimes.get(key)
        if tables is None:
            print(f"No traveltime lookup table available for '{key}'.")
        return tables
