"""The paper's own "architecture": the FP16 approximate square-root unit.

Not an LM: this config names what the paper's evaluation (Table 3, Table 4,
Fig. 5; ``repro_torch.launch.paper``) runs.  It sits in the same registry
as the models, as ``e2afs-fp16``; code that builds an LM from every id
skips it."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class E2AFSConfig:
    name: str = "e2afs-fp16"
    sqrt_unit: str = "e2afs"
    baselines: tuple = ("esas", "cwaha4", "cwaha8")
    fmt: str = "fp16"

    def validate(self):
        return self


def config():
    return E2AFSConfig().validate()


def smoke_config():
    return config()
