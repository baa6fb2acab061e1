"""GreenDyGNN core: cost laws, energy meter, windowed cache, controller."""
