"""Core: the stencil IR and the Hopper blocking planner."""
