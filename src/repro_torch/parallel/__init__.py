"""The parallel layer: mesh context, partition rules, gradient compression."""
