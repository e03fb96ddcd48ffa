"""onboard_ms_per_adapter: host clock around each synchronized
``AdapterStore.register_many`` (LoRAQuant on the device), per adapter."""


def read(out):
    return out.onboard_s * 1e3 / out.adapters if out.adapters else None
