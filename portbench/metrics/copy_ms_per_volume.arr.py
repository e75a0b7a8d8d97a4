"""Device ms a volume of host-to-device and device-to-host copies over the
traced call (the profiler's Memcpy HtoD and DtoH rows)."""


def read(ctx):
    us, n = ctx.slice.device_us(
        lambda name: name.startswith("Memcpy")
        and ("HtoD" in name or "DtoH" in name))
    if not n:
        return None
    return us / 1e3 / ctx.items
