"""The image configuration: fogleman/sdf ``examples/image.py``, an image
embossed as a relief on a rounded plate.

``build(api, v)`` writes the upstream script's three lines against the
public fogleman/sdf API, with each length taken from ``v`` (see
``knurling.py``) and the script's ``IMAGE`` resolved from the repository's
root.  The texture is built in every request (the image loaded, two exact
distance transforms, the signed texture), as a user's re-run of the script
builds it.  ``api`` is the program's package for a timed request; for the
check it is the reference's ``sdf.py``, and the texture and the other
nodes come from the reference's ``textures.py`` beside it.
"""

from pathlib import Path

IMAGE = str(Path(__file__).resolve().parents[2] / "examples" / "butterfly.png")


def build(api, v):
    if api.__name__ == "reference.sdf":
        from reference import textures as api
    w, h = api.measure_image(IMAGE)
    f = api.rounded_box((w * v["plate_margin"], h * v["plate_margin"],
                         v["plate_thickness"]), v["plate_round"])
    f |= api.image(IMAGE).extrude(v["relief_extrude"]) & api.slab(
        z0=0, z1=v["relief_top"])
    return f
