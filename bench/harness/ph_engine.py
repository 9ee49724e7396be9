"""Build the program's engine from a configuration's ``engine`` entry
(every ``PHConfig`` field it sets; ``tile`` is a ``TileSpec``)."""
from __future__ import annotations


def build(config: dict, device, overrides: dict | None = None):
    from repro_torch.ph import PHConfig, PHEngine, TileSpec
    fields = dict(config["engine"])
    fields.update(overrides or {})
    if "tile" in fields and fields["tile"] is not None:
        tile = dict(fields["tile"])
        if tile.get("grid") is not None:
            tile["grid"] = tuple(tile["grid"])
        fields["tile"] = TileSpec(**tile)
    return PHEngine(PHConfig(**fields), device=device)


def host_diagram(diagram) -> tuple:
    """Every field of a returned diagram copied to host memory."""
    return tuple(f.cpu() for f in diagram)
