"""CLI: headless path-traced render of a glTF/.pt scene to PNG.

The offline replacement for the reference's interactive `pt` viewer
(src/pt/main.cpp): all ImGui parameters (spp, bounces, sun zenith/azimuth,
turbidity, vfov, exposure stops, camera pose) become flags with the same
defaults (main.cpp:46-60, fly_camera_controller.hpp:47-56).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

from ..render.pathtracer import DEFAULT_ENGINE, ENGINES


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "scene", type=pathlib.Path,
        help=".glb/.gltf or .pt scene, or procedural:courtyard[:subdiv] "
        "(the built-in Sponza-scale interior; subdiv 26 = 254K tris)",
    )
    parser.add_argument("-o", "--output", type=pathlib.Path, default=pathlib.Path("render.png"))
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--spp", type=int, default=64, help="samples per pixel (UI default 64)")
    parser.add_argument("--bounces", type=int, default=2, help="path bounces (UI default 2)")
    parser.add_argument("--vfov", type=float, default=70.0)
    parser.add_argument("--sun-zenith", type=float, default=30.0)
    parser.add_argument("--sun-azimuth", type=float, default=0.0)
    parser.add_argument("--turbidity", type=float, default=1.0)
    parser.add_argument("--albedo", type=float, nargs=3, default=[1.0, 1.0, 1.0])
    parser.add_argument("--exposure-stops", type=int, default=2, help="exposure = 2^-stops")
    parser.add_argument("--aperture", type=float, default=0.0)
    parser.add_argument("--focus-distance", type=float, default=10.0)
    parser.add_argument("--camera-origin", type=float, nargs=3, default=None)
    parser.add_argument("--camera-look-at", type=float, nargs=3, default=None)
    parser.add_argument(
        "--engine",
        choices=ENGINES,
        default=DEFAULT_ENGINE,
        help="traversal engine: the per-ray BVH walk, the XLA wavefront "
        "cluster walk, or the lockstep reference",
    )
    parser.add_argument(
        "--mesh", default=None, metavar="TILESxSAMPLES",
        help="render across a multi-device mesh, e.g. 4x2 = 4-way "
        "pixel-tile sharding x 2-way sample sharding (requires "
        "tiles*samples visible devices; spp must divide the samples axis)",
    )
    args = parser.parse_args(argv)

    from ..render.camera import create_camera
    from ..render.pathtracer import SamplingParams, render_image
    from ..render.scene import load_device_scene
    from ..sky.model import sky_state_from_ui
    from ..utils.image import write_png

    scene_arg = str(args.scene)
    if scene_arg.startswith("procedural:"):
        from ..render.scene import build_device_scene
        from ..scene.procedural import courtyard_scene

        parts = scene_arg.split(":")
        if parts[1] != "courtyard":
            parser.error(f"unknown procedural scene {parts[1]!r}")
        subdiv = int(parts[2]) if len(parts) > 2 else 8
        flat, textures = courtyard_scene(subdiv)
        scene = build_device_scene(flat, textures=textures)
    else:
        scene = load_device_scene(args.scene)
    print(f"scene: {scene.num_triangles} triangles, {scene.num_nodes} BVH nodes")

    if args.camera_origin is None or args.camera_look_at is None:
        # Auto-frame from the root AABB like bvh-visualizer (main.cpp:36-55).
        lo = np.asarray(scene.bvh_aabb_min[0])
        hi = np.asarray(scene.bvh_aabb_max[0])
        diag = hi - lo
        centroid = 0.5 * (lo + hi)
        if diag[0] > diag[1] and diag[0] > diag[2]:
            max_dim = 0
        elif diag[1] > diag[2]:
            max_dim = 1
        else:
            max_dim = 2
        origin = args.camera_origin or (
            centroid - np.asarray([-0.8 * diag[max_dim], 0.0, 0.8 * diag[max_dim]])
        )
        look_at = args.camera_look_at or centroid
    else:
        origin, look_at = args.camera_origin, args.camera_look_at

    camera = create_camera(
        origin,
        look_at,
        args.aperture,
        args.focus_distance,
        args.vfov,
        args.width / args.height,
    )
    sky = sky_state_from_ui(args.turbidity, tuple(args.albedo), args.sun_zenith, args.sun_azimuth)

    t0 = time.time()
    if args.mesh is not None:
        import jax

        from ..parallel.sharding import (
            make_render_mesh,
            render_image_sharded_regen,
        )

        try:
            tiles, samples = (int(x) for x in args.mesh.lower().split("x"))
        except ValueError:
            parser.error(f"--mesh must be TILESxSAMPLES, got {args.mesh!r}")
        devices = jax.devices()
        if tiles * samples > len(devices):
            parser.error(
                f"--mesh {args.mesh} needs {tiles * samples} devices, "
                f"only {len(devices)} visible"
            )
        if args.spp % samples:
            parser.error(f"--spp {args.spp} must divide the samples axis {samples}")
        mesh = make_render_mesh(devices[: tiles * samples], sample_parallel=samples)
        img = render_image_sharded_regen(
            scene,
            sky,
            camera,
            mesh=mesh,
            width=args.width,
            height=args.height,
            spp=args.spp,
            num_bounces=args.bounces,
            exposure=2.0 ** -args.exposure_stops,
            engine=args.engine,
        )
    else:
        img = render_image(
            scene,
            sky,
            camera,
            width=args.width,
            height=args.height,
            sampling=SamplingParams(args.spp, args.bounces),
            exposure=2.0 ** -args.exposure_stops,
            engine=args.engine,
        )
    dt = time.time() - t0
    rays = args.width * args.height * args.spp * (2 * args.bounces)  # closest+shadow per bounce
    print(f"rendered {args.width}x{args.height} @ {args.spp}spp in {dt:.1f}s "
          f"(~{rays / dt / 1e6:.2f} Mrays/s)")
    write_png(args.output, img)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
