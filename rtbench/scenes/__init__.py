"""The program's scene recipes, one module a recipe: `build(cfg, spp, lit)`
returns (scene, viewport) through the port's own API."""
