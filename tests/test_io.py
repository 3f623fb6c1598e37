"""Dataset loaders + CLI smoke test on fabricated mini datasets."""

import os

import numpy as np
from PIL import Image

from sdslam_tpu.io import datasets


def make_mini_tum(root, n=3):
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines = [], []
    rng = np.random.default_rng(0)
    for i in range(n):
        ts = 1000.0 + i / 30.0
        img = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "rgb", f"{i}.png"))
        d = (rng.uniform(0.5, 3.0, (48, 64)) * 5000).astype(np.uint16)
        Image.fromarray(d).save(os.path.join(root, "depth", f"{i}.png"))
        rgb_lines.append(f"{ts:.6f} rgb/{i}.png")
        # depth slightly offset in time (association must still pair them)
        depth_lines.append(f"{ts + 0.005:.6f} depth/{i}.png")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# comment\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(depth_lines) + "\n")


def test_associate_nearest():
    a = [(1.0, "a0"), (2.0, "a1"), (3.0, "a2")]
    b = [(1.009, "b0"), (2.5, "bx"), (3.001, "b2")]
    out = datasets.associate(a, b, max_difference=0.02)
    assert [(x[1], x[3]) for x in out] == [("a0", "b0"), ("a2", "b2")]


def test_tum_rgbd_loader(tmp_path):
    make_mini_tum(str(tmp_path))
    ds = datasets.TUMRGBDDataset(str(tmp_path))
    assert len(ds) == 3
    ts, img, depth = ds.frame(0)
    assert img.shape == (48, 64) and depth.shape == (48, 64)
    assert 0.4 < depth.mean() < 3.1  # scaled by 5000
    assert abs(ts - 1000.0) < 1e-6


def test_tum_mono_loader(tmp_path):
    make_mini_tum(str(tmp_path))
    ds = datasets.TUMMonoDataset(str(tmp_path))
    assert len(ds) == 3
    ts, img = ds.frame(1)
    assert img.shape == (48, 64)


def test_euroc_loader(tmp_path):
    cam_dir = tmp_path / "mav0" / "cam0" / "data"
    imu_dir = tmp_path / "mav0" / "imu0"
    os.makedirs(cam_dir)
    os.makedirs(imu_dir)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        ns = 1_000_000_000 + i * 50_000_000
        name = f"{ns}.png"
        Image.fromarray(rng.integers(0, 255, (32, 40), dtype=np.uint8)).save(
            cam_dir / name
        )
        rows.append(f"{ns},{name}")
    (tmp_path / "mav0" / "cam0" / "data.csv").write_text(
        "#ts,filename\n" + "\n".join(rows) + "\n"
    )
    imu_rows = [
        f"{1_000_000_000 + i * 5_000_000},{0.1*i},0.2,0.3,9.8,0.0,0.1"
        for i in range(30)
    ]
    (imu_dir / "data.csv").write_text("#header\n" + "\n".join(imu_rows) + "\n")
    ds = datasets.EuRoCDataset(str(tmp_path))
    assert len(ds) == 3
    ts, img = ds.frame(0)
    assert img.shape == (32, 40)
    between = ds.imu_between(ds.items[0][0], ds.items[1][0])
    assert len(between) == 10


def test_cli_synthetic_smoke(tmp_path):
    from sdslam_tpu import cli

    traj = str(tmp_path / "traj.txt")
    mp = str(tmp_path / "map.npz")
    cli.main(
        ["synthetic", "--frames", "6", "--traj-out", traj, "--save-map", mp]
    )
    assert os.path.exists(traj)
    assert len(open(traj).read().strip().splitlines()) == 6
    assert os.path.exists(mp)


def test_native_extension_matches_python():
    from sdslam_tpu import native

    _native = native.load()
    assert _native is not None, "native extension failed to build"
    a = [(1.0, "a0"), (2.0, "a1"), (3.0, "a2"), (4.0, "a3")]
    b = [(1.009, "b0"), (2.5, "bx"), (3.001, "b2"), (4.019, "b3")]
    out = datasets.associate(a, b, max_difference=0.02)
    assert [(x[1], x[3]) for x in out] == [("a0", "b0"), ("a2", "b2"), ("a3", "b3")]

    rng = np.random.default_rng(3)
    d1 = rng.integers(0, 256, (9, 32), dtype=np.uint8)
    d2 = rng.integers(0, 256, (11, 32), dtype=np.uint8)
    out_m = np.empty((9, 11), np.int32)
    _native.hamming_matrix_u8(d1.tobytes(), d2.tobytes(), out_m)
    ref = np.array(
        [[np.unpackbits(np.bitwise_xor(d1[i], d2[j])).sum() for j in range(11)]
         for i in range(9)]
    )
    np.testing.assert_array_equal(out_m, ref)


def test_native_prefetch_iter(tmp_path):
    """Native threaded prefetcher yields the same frames as the PIL path."""
    import os

    from PIL import Image

    from sdslam_tpu.io.datasets import TUMRGBDDataset

    root = tmp_path / "seq"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rng = np.random.default_rng(3)
    rgb_lines, dep_lines = [], []
    for k in range(4):
        img = rng.integers(0, 255, (24, 32), dtype=np.uint8)
        dep = rng.integers(100, 30000, (24, 32), dtype=np.uint16)
        Image.fromarray(img).save(root / "rgb" / f"{k}.png")
        Image.fromarray(dep).save(root / "depth" / f"{k}.png")
        rgb_lines.append(f"{k}.0 rgb/{k}.png")
        dep_lines.append(f"{k}.01 depth/{k}.png")
    (root / "rgb.txt").write_text("\n".join(rgb_lines))
    (root / "depth.txt").write_text("\n".join(dep_lines))

    ds = TUMRGBDDataset(str(root), depth_factor=1000.0)
    sync = list(ds)
    pre = list(ds.prefetch_iter(n_threads=2, depth=2))
    assert len(pre) == len(sync) == 4
    for (t1, i1, d1), (t2, i2, d2) in zip(sync, pre):
        assert t1 == t2
        assert np.allclose(i1, i2)
        assert np.allclose(d1, d2)
    raw = list(ds.prefetch_iter(raw=True))
    assert raw[0][1].dtype == np.uint8 and raw[0][2].dtype == np.uint16
