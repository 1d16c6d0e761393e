"""Re-render the courtyard showcase images (procedural 254K-tri interior,
full 4-bounce GI, default engine). Writes showcase/courtyard_{res}_{spp}.png.

Usage: python showcase/render_courtyard.py [1080p32|720p16|1080p8]
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np

from rayfinder_tpu.render.camera import create_camera
from rayfinder_tpu.render.pathtracer import SamplingParams, render_image_tiled
from rayfinder_tpu.render.scene import build_device_scene
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky.model import sky_state_from_ui
from rayfinder_tpu.utils.image import write_png

CONFIGS = {
    "1080p32": (1920, 1080, 32, "courtyard_1080p_32spp.png", False, False),
    "1080p8": (1920, 1080, 8, "courtyard_1080p_8spp.png", False, False),
    "720p16": (1280, 720, 16, "courtyard_720p_16spp.png", False, False),
    "tex720p16": (1280, 720, 16, "courtyard_textured_720p_16spp.png", True, False),
    # The PRODUCTION ASSET PATH at benchmark scale: courtyard -> GLB ->
    # gltf loader -> .pt file -> device scene (the reference's
    # pt-format-tool -> pt flow) -> render.
    "pt720p16": (1280, 720, 16, "courtyard_pt_720p_16spp.png", True, True),
    "pt1080p32": (1920, 1080, 32, "courtyard_pt_1080p_32spp.png", True, True),
}

which = sys.argv[1] if len(sys.argv) > 1 else "1080p32"
w, h, spp, name, textured, via_pt = CONFIGS[which]

if via_pt:
    import tempfile

    from rayfinder_tpu.tools.export_glb import device_scene_via_pt

    flat, textures = courtyard_scene(26, textured=textured)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        scene = device_scene_via_pt(flat, textures, tmp)
    print(f"GLB -> .pt -> device scene in {time.time()-t0:.0f}s; "
          f"tris: {scene.num_triangles}")
else:
    flat, textures = courtyard_scene(26, textured=textured)
    print("tris:", flat.positions.shape[0])
    scene = build_device_scene(flat, textures=textures)
camera = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)

t0 = time.time()
img = render_image_tiled(
    scene, sky, camera, width=w, height=h,
    sampling=SamplingParams(spp, 4), exposure=0.25,
    samples_per_dispatch=4,
)
assert np.isfinite(img).all()
out = pathlib.Path(__file__).parent / name
write_png(str(out), img)
print(f"wrote {out} in {time.time()-t0:.0f}s")
