"""Core layer: Morton coding, the quadtree index, the sweep, plans, ticks."""
