"""CAD-side scene exporter: author model_export.json without SketchUp.

The reference ships a SketchUp Ruby plugin (ruby_SU/RoomExporter/
RoomExport.rb) as the only way to produce new scenes.  This module is the
framework-native equivalent: feed it faces (triangles or convex polygons)
painted with front/back material names - the SketchUp paint model - and it
applies the plugin's exact classification semantics (RoomExport.rb:86-230):

- no material on either side         -> '_RIGID', sides flag 0
- back side painted, front unpainted -> back material, sides 1
- front painted, back unpainted      -> front material, sides 2
- both sides painted, SAME material  -> that material, sides 3
- both painted, DIFFERENT materials  -> the face is moved to the '_TOFIX'
  quarantine (excluded from export, reported) exactly like the plugin's
  _TOFIX layer (RoomExport.rb:86-94)

plus fan triangulation of convex polygons, unit conversion (the plugin
hardcodes inches->metres, :133-151), exact vertex dedup per material
(:161-174), and source/receiver intake from CSVs with delimiter sniffing
and a bounding-box warning (:291-353).

Works with any mesh source (trimesh, Blender exports, hand-built arrays);
the output loads straight into RoomGeo / sim_setup.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pffdtd_jax.geometry.scene_io import read_positions_csv, write_model_json

INCHES2METRES = 0.0254


class SceneExporter:
    """Accumulates painted faces and writes the reference JSON schema."""

    def __init__(self, unit_scale: float = 1.0):
        self.unit_scale = float(unit_scale)
        self._mats: dict[str, dict] = {}
        self._colors: dict[str, tuple] = {}
        self.tofix: list[np.ndarray] = []   # quarantined face vertex lists
        self.counts = {"n_faces": 0, "n_faces_rigid": 0, "n_faces_tofix": 0}

    # ------------------------------------------------------------- faces
    def set_color(self, mat: str, rgb):
        self._colors[mat] = tuple(int(c) for c in rgb)

    def add_face(self, verts, front: str | None = None,
                 back: str | None = None):
        """Add one planar face (K >= 3 vertices, convex; fan-triangulated).

        front/back: material names painted on each side (None = unpainted).
        """
        verts = np.asarray(verts, np.float64) * self.unit_scale
        assert verts.ndim == 2 and verts.shape[1] == 3 and len(verts) >= 3
        self.counts["n_faces"] += 1

        if front is not None and back is not None and front != back:
            self.counts["n_faces_tofix"] += 1
            self.tofix.append(verts)
            return
        if back is not None and front is None:
            mat, side = back, 1
        elif front is not None and back is None:
            mat, side = front, 2
        elif front is not None:
            mat, side = front, 3
        else:
            mat, side = "_RIGID", 0
            self.counts["n_faces_rigid"] += 1

        m = self._mats.setdefault(mat, {"pts": [], "tris": [], "sides": []})
        base = len(m["pts"])
        m["pts"].extend(map(tuple, verts))
        for j in range(1, len(verts) - 1):      # fan triangulation
            m["tris"].append((base, base + j, base + j + 1))
            m["sides"].append(side)

    def add_mesh(self, pts, tris, front: str | None = None,
                 back: str | None = None):
        """Add a triangle mesh with one paint for all faces."""
        pts = np.asarray(pts, np.float64)
        for tri in np.asarray(tris, np.int64):
            self.add_face(pts[tri], front=front, back=back)

    # ------------------------------------------------------------ export
    def _dedup(self):
        mats = {}
        for name, m in self._mats.items():
            pts = m["pts"]
            uniq: dict[tuple, int] = {}
            remap = []
            for p in pts:
                if p not in uniq:
                    uniq[p] = len(uniq)
                remap.append(uniq[p])
            tris = [[remap[i] for i in t] for t in m["tris"]]
            mats[name] = {
                "pts": np.asarray(list(uniq.keys()), np.float64),
                "tris": np.asarray(tris, np.int64),
                "sides": np.asarray(m["sides"], np.int64),
                "color": self._colors.get(name, (128, 128, 128)),
            }
        return mats

    def export(self, path, sources, receivers):
        """Write model_export.json; sources/receivers are (N, 3) arrays or
        CSV paths (delimiter-sniffed).  Returns a summary dict; positions
        outside the scene bbox are listed in summary['warnings'] (the
        plugin pops a warning box, RoomExport.rb:291-353)."""
        if isinstance(sources, (str, Path)):
            sources = read_positions_csv(sources)
        if isinstance(receivers, (str, Path)):
            receivers = read_positions_csv(receivers)
        sources = np.atleast_2d(np.asarray(sources, np.float64))
        receivers = np.atleast_2d(np.asarray(receivers, np.float64))

        mats = self._dedup()
        if not mats:
            raise ValueError("no exportable faces (all rigid-empty or "
                             "_TOFIX?)")
        allpts = np.concatenate([m["pts"] for m in mats.values()])
        bmin, bmax = allpts.min(0), allpts.max(0)
        warnings = []
        for kind, arr in (("source", sources), ("receiver", receivers)):
            for i, p in enumerate(arr):
                if (p < bmin).any() or (p > bmax).any():
                    warnings.append(f"{kind} {i + 1} at {p.tolist()} is "
                                    f"outside the model bounding box")
        if self.counts["n_faces_tofix"]:
            warnings.append(f"{self.counts['n_faces_tofix']} two-sided-"
                            "mismatch face(s) quarantined to _TOFIX and "
                            "NOT exported")

        write_model_json(path, mats, sources, receivers)
        npts = sum(len(m["pts"]) for m in mats.values())
        ntris = sum(len(m["tris"]) for m in mats.values())
        return {"npts": npts, "ntris": ntris, "nmats": len(mats),
                "warnings": warnings, **self.counts}


def export_box_room(path, L, mat_by_wall, sources, receivers,
                    unit_scale: float = 1.0):
    """Convenience: axis-aligned box room with per-wall paints.

    mat_by_wall: dict with keys x0,x1,y0,y1,z0,z1 -> material name or None
    (rigid).  Faces are painted on their INTERIOR side (sides=2 with
    outward vertex winding)."""
    L = np.asarray(L, np.float64)
    ex = SceneExporter(unit_scale=unit_scale)
    quads = {
        "x0": [(0, 0, 0), (0, L[1], 0), (0, L[1], L[2]), (0, 0, L[2])],
        "x1": [(L[0], 0, 0), (L[0], 0, L[2]), (L[0], L[1], L[2]),
               (L[0], L[1], 0)],
        "y0": [(0, 0, 0), (0, 0, L[2]), (L[0], 0, L[2]), (L[0], 0, 0)],
        "y1": [(0, L[1], 0), (L[0], L[1], 0), (L[0], L[1], L[2]),
               (0, L[1], L[2])],
        "z0": [(0, 0, 0), (L[0], 0, 0), (L[0], L[1], 0), (0, L[1], 0)],
        "z1": [(0, 0, L[2]), (0, L[1], L[2]), (L[0], L[1], L[2]),
               (L[0], 0, L[2])],
    }
    for wall, verts in quads.items():
        ex.add_face(verts, front=mat_by_wall.get(wall))
    return ex.export(path, sources, receivers)
