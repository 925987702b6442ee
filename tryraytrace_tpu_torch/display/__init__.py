"""Display layer: the drop-frame pipeline, input sources and the apps
(display/app.py)."""
