"""Physical constants used by the wind-field gallery (as compose_tpu's)."""

earth_radius_m = 6.37122e6


def day2sec(d):
    return d * 86400.0
