"""The kinds of scene sets a traffic mix can name: ``scenes.kind`` in its
file is the name of a module here whose ``scene_paths(spec, cache_root)``
returns the scene JSON files, so a new kind is a new module."""
