from . import camera, point_cloud, profiler, sh, transforms  # noqa: F401
