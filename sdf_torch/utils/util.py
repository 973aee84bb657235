"""Angle constants/helpers re-exported at package level (ref sdf/util.py)."""

import math

pi = math.pi

degrees = math.degrees
radians = math.radians
