"""Model modules with the mmdet checkpoint key schema."""
