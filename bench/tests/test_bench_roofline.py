"""The byte counts of the roofline metrics, pinned at dfa-port's shapes
against figures worked by hand."""
from bench import roofline


def test_ingest_bytes_at_dfa_port():
    # 2^20 events x (4 + 4 + 20 + 1) B = 30,408,704 B; 100,000 touched
    # slots x 2 x (28 + 4 + 20 + 1) B = 10,600,000 B
    assert roofline.ingest_bytes(1 << 20, 100_000) == 41_008_704


def test_enrich_bytes_at_dfa_port():
    # 4,096 reported flows x 10 entries x 65 B = 2,662,400 B; 4,096 rows x
    # (96 + 8) x 4 B = 1,703,936 B
    assert roofline.enrich_bytes(4096, 4096, 10, 96, 8) == 4_366_336


def test_least_time_and_share():
    # 41,008,704 B at 3.35e12 B/s = 12.2414 us; over 100 us of device time
    t = roofline.least_seconds(41_008_704)
    assert abs(t - 12.241404179104478e-6) < 1e-15
    assert abs(roofline.share_pct(41_008_704, 100e-6) - 12.241404179104478) \
        < 1e-9
    assert roofline.share_pct(1, 0.0) is None
