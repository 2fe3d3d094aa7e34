"""The reference's scene recipes, one module a recipe: `build(cfg, spp)`
returns (triangles, light or None, viewport) from a configuration's own
parameters."""
