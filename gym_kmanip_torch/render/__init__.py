"""Camera rendering (render/raycast.py)."""
