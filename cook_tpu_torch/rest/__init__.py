"""REST API layer, served on the standard library (rest/http.py).

`ApiConfig` and `CookApi` load lazily, so that `rest.http` and
`rest.server` (which the sandbox file server runs on) import no torch."""


def __getattr__(name):
    if name in ("ApiConfig", "CookApi"):
        from cook_tpu_torch.rest import api

        return getattr(api, name)
    raise AttributeError(
        f"module 'cook_tpu_torch.rest' has no attribute {name!r}")
