"""Pod sidecar: the sandbox file server.

Port of `cook_tpu/sidecar/`, on the standard library.  `FileServer` loads
lazily, so that `python -m cook_tpu_torch.sidecar.fileserver` runs the
module once."""


def __getattr__(name):
    if name == "FileServer":
        from cook_tpu_torch.sidecar.fileserver import FileServer

        return FileServer
    raise AttributeError(
        f"module 'cook_tpu_torch.sidecar' has no attribute {name!r}")
