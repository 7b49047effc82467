"""Entry points: ``serve`` runs the model server behind the gateway."""
