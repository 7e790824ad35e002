"""REST API layer, served on the standard library (rest/http.py)."""
from cook_tpu_torch.rest.api import ApiConfig, CookApi  # noqa: F401
