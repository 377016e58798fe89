"""The traffic is the same for one seed and differs across seeds."""
import math

from rtbench.harness.registry import Registry


def test_turntable_angles_follow_the_seed_and_stay_in_range():
    turntable = Registry().runner("turntable")
    a = turntable.angles(2 ** 31 + 7, 500, 0.5, 30.0)
    assert a == turntable.angles(2 ** 31 + 7, 500, 0.5, 30.0)
    assert a != turntable.angles(2 ** 31 + 8, 500, 0.5, 30.0)
    assert all(abs(x) <= 30.0 + 1e-9 for x in a)
    steps = {round(abs(y - x), 9) for x, y in zip(a, a[1:])}
    assert steps == {0.5}


def test_turned_camera_keeps_radius_height_and_target():
    turntable = Registry().runner("turntable")
    scene = Registry().config("csg_showcase")["scene"]
    cam0 = scene["camera"]
    cam = turntable.turned(scene, 17.0)["camera"]
    r = lambda c: math.hypot(c["from"][0] - c["to"][0],
                             c["from"][2] - c["to"][2])
    assert abs(r(cam) - r(cam0)) < 1e-12
    assert cam["from"][1] == cam0["from"][1] and cam["to"] == cam0["to"]
    back = turntable.turned(scene, 0.0)["camera"]["from"]
    assert max(abs(a - float(b)) for a, b in zip(back, cam0["from"])) < 1e-12


def test_adam_start_follows_the_seed():
    adam = Registry().runner("adam")
    scene = Registry().config("glass")["scene"]
    a = adam.perturbed(scene, 3_000_000_001, 0.5, 1.5)
    assert a == adam.perturbed(scene, 3_000_000_001, 0.5, 1.5)
    assert a != adam.perturbed(scene, 3_000_000_002, 0.5, 1.5)
    assert a["camera"] == scene["camera"]
    colours = []

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ("color", "color_a", "color_b"):
                    colours.append(v)
                else:
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(a["scene"])
    assert colours and all(0.0 <= c <= 1.0 for v in colours for c in v)
    assert a["lights"][0]["color"] != scene["lights"][0]["color"]
