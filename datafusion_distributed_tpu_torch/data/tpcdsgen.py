"""Synthetic TPC-DS dataset generator (all 24 tables; port of the
reference `data/tpcdsgen.py`, numpy and pyarrow only).

Upstream, TPC-DS parquet is pre-generated by the datafusion-benchmarks
repository (`benchmarks/src/datasets/tpcds.rs` `download_benchmarks`) and
its plan and correctness suites run against it. Nothing here may be
downloaded, so the dataset is generated: spec-shaped schemas (the columns
and types the 99 queries touch, plus the standard surrogate keys),
spec-domain value pools (categories, states, education levels, buy
potentials, so that query literals select rows), and referential integrity
between fact and dimension tables. Row counts scale with ``sf`` as dsdgen's
scale factor does, with the spec's fixed-size dimensions kept fixed.

It makes exactly the reference generator's RNG calls in the same order, so
the same ``sf`` and ``seed`` give the same Arrow tables, value for value.
Statistical fidelity to dsdgen is NOT a goal: any self-consistent dataset
serves plan tests and oracle-checked correctness tests.
"""

from __future__ import annotations

import numpy as np

# spec calendar: queries filter d_year in 1998..2002
_DATE_LO = np.datetime64("1998-01-01")
_DATE_HI = np.datetime64("2003-01-01")
_SK0 = 2450815  # d_date_sk of 1998-01-01 (spec-like julian base)

_CATEGORIES = ["Home", "Books", "Electronics", "Jewelry", "Sports",
               "Women", "Men", "Children", "Music", "Shoes"]
_CLASSES = ["accent", "bedding", "blinds/shades", "curtains/drapes",
            "decor", "flatware", "furniture", "glassware", "kids",
            "lighting", "mattresses", "paint", "rugs", "tables",
            "wallpaper", "classical", "country", "pop", "rock",
            "fiction", "history", "mystery", "romance", "science",
            "computers", "cameras", "audio", "stereo", "televisions",
            "football", "baseball", "basketball", "camping", "fishing",
            "golf", "hockey", "tennis", "athletic", "dresses", "maternity",
            "pants", "shirts", "swimwear", "infants", "newborn", "toddlers",
            "school-uniforms", "accessories", "mens", "womens", "pendants",
            "rings", "earings", "bracelets", "diamonds", "gold"]
_BRAND_POOL = [f"{a}{b} #{n}" for a in
               ["amalg", "edu pack", "scholar", "import", "corp", "brand",
                "univ", "exporti", "maxi", "nameless"]
               for b in ["amalg", "exporti", "maxi", "importo", "corp",
                         "brand", "scholar", "univ", "unimax", "nameless"]
               for n in (1, 2)]
_COLORS = ["pale", "papaya", "peach", "peru", "pink", "plum", "powder",
           "puff", "purple", "red", "rose", "rosy", "royal", "saddle",
           "salmon", "sandy", "seashell", "sienna", "silver", "sky",
           "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
           "tomato", "turquoise", "violet", "wheat", "white", "yellow",
           "almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blanched", "blue", "blush", "brown", "burlywood",
           "burnished", "chartreuse", "chiffon", "chocolate", "coral",
           "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
           "dim", "dodger", "drab", "firebrick", "floral", "forest",
           "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
           "honeydew", "hot", "indian", "ivory", "khaki", "lace",
           "lavender", "lawn", "lemon", "light", "lime", "linen",
           "magenta", "maroon", "medium", "metallic", "midnight", "mint",
           "misty", "moccasin", "navajo", "navy", "olive", "orange",
           "orchid", "pale"]
_SIZES = ["petite", "small", "medium", "large", "extra large", "N/A",
          "economy"]
_UNITS = ["Each", "Dozen", "Case", "Pack", "Box", "Carton", "Unknown",
          "Oz", "Lb", "Ton", "Pallet", "Gross", "Cup", "Dram", "Tbl",
          "Bunch", "Tsp", "Ounce", "Bundle", "N/A"]
_STATES = ["AL", "AR", "CA", "CO", "FL", "GA", "IA", "IL", "IN", "KS",
           "KY", "LA", "MI", "MN", "MO", "MS", "NC", "ND", "NE", "NM",
           "NY", "OH", "OK", "OR", "PA", "SC", "SD", "TN", "TX", "UT",
           "VA", "WA", "WI", "WV"]
_COUNTIES = ["Ziebach County", "Williamson County", "Walker County",
             "Ventura County", "Terrell County", "Sumner County",
             "Salem County", "Rush County", "Richland County",
             "Raleigh County", "Perry County", "Oglethorpe County",
             "Mobile County", "Luce County", "Lea County",
             "Jackson County", "Huron County", "Franklin Parish",
             "Fairfield County", "Dona Ana County", "Daviess County",
             "Bronx County", "Barrow County", "Arthur County"]
_CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Centerville",
           "Liberty", "Pleasant Hill", "Union", "Salem", "Riverside",
           "Greenville", "Bethel", "Clinton", "Marion", "Springdale",
           "Antioch", "Concord", "Edgewood", "Farmington", "Glendale",
           "Hamilton", "Jackson", "Kingston", "Lakeside", "Maple Grove",
           "Newport", "Oakland", "Plainview", "Shiloh", "Sunnyside",
           "Walnut Grove", "Wildwood", "Woodland", "Mount Olive",
           "Pleasant Valley", "Red Hill", "Stringtown", "Unionville",
           "White Oak", "Lebanon"]
_COUNTRIES = ["United States"]
_GENDERS = ["M", "F"]
_MARITAL = ["M", "S", "D", "W", "U"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]
_CREDIT_RATINGS = ["Low Risk", "Good", "High Risk", "Unknown"]
_BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                  "0-500", "Unknown"]
_STREET_TYPES = ["Street", "Ave", "Blvd", "Ct", "Dr", "Ln", "Pkwy",
                 "Rd", "Way", "Circle"]
_STREET_NAMES = ["Main", "Oak", "Park", "Elm", "First", "Second", "Third",
                 "Fourth", "Cedar", "Pine", "Maple", "Walnut", "Washington",
                 "Lake", "Hill", "College", "Church", "Spring", "Sunset",
                 "Railroad", "Mill", "River", "Highland", "Johnson",
                 "Smith", "Wilson", "Center", "Green", "Lee", "Jackson",
                 "Adams", "Davis", "Locust", "Broadway", "Dogwood",
                 "Hickory", "Poplar", "Sycamore", "View", "Williams"]
_FIRST_NAMES = ["James", "John", "Robert", "Michael", "William", "David",
                "Mary", "Patricia", "Linda", "Barbara", "Elizabeth",
                "Jennifer", "Maria", "Susan", "Margaret", "Dorothy",
                "Lisa", "Nancy", "Karen", "Betty", "Helen", "Sandra",
                "Donna", "Carol", "Ruth", "Sharon", "Michelle", "Laura",
                "Sarah", "Kimberly", "Richard", "Charles", "Joseph",
                "Thomas", "Christopher", "Daniel", "Paul", "Mark",
                "Donald", "George", "Kenneth", "Steven", "Edward",
                "Brian", "Ronald", "Anthony", "Kevin", "Jason", "Matthew",
                "Gary"]
_LAST_NAMES = ["Smith", "Johnson", "Williams", "Jones", "Brown", "Davis",
               "Miller", "Wilson", "Moore", "Taylor", "Anderson", "Thomas",
               "Jackson", "White", "Harris", "Martin", "Thompson",
               "Garcia", "Martinez", "Robinson", "Clark", "Rodriguez",
               "Lewis", "Lee", "Walker", "Hall", "Allen", "Young",
               "Hernandez", "King", "Wright", "Lopez", "Hill", "Scott",
               "Green", "Adams", "Baker", "Gonzalez", "Nelson", "Carter",
               "Mitchell", "Perez", "Roberts", "Turner", "Phillips",
               "Campbell", "Parker", "Evans", "Edwards", "Collins"]
_SALUTATIONS = ["Mr.", "Mrs.", "Ms.", "Miss", "Dr.", "Sir"]
_MEAL_TIMES = ["breakfast", "dinner", "lunch", ""]
_SHIP_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
                  "PRIVATECARRIER", "ALLIANCE", "ORIENTAL", "BARIAN",
                  "BOXBUNDLES", "ZOUROS", "GREAT EASTERN", "DIAMOND",
                  "RUPEKSA", "GERMA", "HARMSTORF", "LATVIAN", "MSC"]
_SHIP_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY",
               "LIBRARY"]
_BUY_COUNTIES = _COUNTIES


def _dec(rng, n, lo, hi):
    """2-digit decimal column."""
    return np.round(rng.uniform(lo, hi, n), 2)


def _pick(rng, pool, n):
    return np.asarray(pool, dtype=object)[rng.integers(0, len(pool), n)]


def _ids(prefix: str, keys: np.ndarray) -> np.ndarray:
    # digits pad to exactly 16 chars INCLUDING the prefix. (A fixed
    # 16-digit format truncated to 16 chopped the LAST digit, colliding
    # ids 0-9 — 500 customers shared 51 c_customer_ids, which broke
    # business-key uniqueness and made q74-class ORDER BY ... LIMIT
    # tie-arbitrary across execution tiers.)
    width = 16 - len(prefix)
    return np.asarray(
        [f"{prefix}{k:0{width}d}" for k in keys], dtype=object
    )


def gen_tpcds(sf: float = 0.01, seed: int = 0) -> dict:
    """Generate all 24 tables as pyarrow Tables, scaled by ``sf``."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    out: dict = {}

    def S(base: int, minimum: int = 1) -> int:
        return max(minimum, int(base * sf))

    # ---- date_dim (fixed calendar) ----------------------------------------
    days = np.arange(_DATE_LO, _DATE_HI, dtype="datetime64[D]")
    nd = len(days)
    d_sk = _SK0 + np.arange(nd)
    dts = days.astype("datetime64[D]").astype(object)
    d_year = np.asarray([d.year for d in dts], dtype=np.int32)
    d_moy = np.asarray([d.month for d in dts], dtype=np.int32)
    d_dom = np.asarray([d.day for d in dts], dtype=np.int32)
    d_dow = np.asarray([d.weekday() for d in dts], dtype=np.int32)
    day_names = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
                 "Saturday", "Sunday"]
    d_qoy = (d_moy - 1) // 3 + 1
    # spec month numbering: d_month_seq counts from 1900 (Jan 1998 = 1176),
    # so the standard query ranges (1176+11, 1200+11, ...) select real data
    month_seq = (d_year - 1900) * 12 + (d_moy - 1)
    week_seq = ((d_sk - _SK0) // 7 + 417).astype(np.int64)
    out["date_dim"] = pa.table({
        "d_date_sk": d_sk.astype(np.int64),
        "d_date_id": _ids("D", d_sk),
        "d_date": days,
        "d_day_name": np.asarray([day_names[w] for w in d_dow], dtype=object),
        "d_dom": d_dom,
        "d_dow": d_dow,
        "d_moy": d_moy,
        "d_qoy": d_qoy,
        "d_year": d_year,
        "d_month_seq": month_seq.astype(np.int64),
        "d_week_seq": week_seq,
        "d_quarter_name": np.asarray(
            [f"{y}Q{q}" for y, q in zip(d_year, d_qoy)], dtype=object
        ),
    })

    # ---- time_dim ---------------------------------------------------------
    nt = 1440  # one row per minute of day
    t_time = np.arange(nt) * 60
    out["time_dim"] = pa.table({
        "t_time_sk": np.arange(nt, dtype=np.int64),
        "t_time_id": _ids("T", np.arange(nt)),
        "t_time": t_time.astype(np.int32),
        "t_hour": (np.arange(nt) // 60).astype(np.int32),
        "t_minute": (np.arange(nt) % 60).astype(np.int32),
        "t_meal_time": np.asarray(
            [("breakfast" if 6 <= h < 9 else
              "lunch" if 11 <= h < 13 else
              "dinner" if 17 <= h < 21 else "")
             for h in np.arange(nt) // 60], dtype=object),
    })

    # ---- item -------------------------------------------------------------
    ni = S(18000, 100)
    i_sk = np.arange(1, ni + 1)
    cat_idx = rng.integers(0, len(_CATEGORIES), ni)
    brand_idx = rng.integers(0, len(_BRAND_POOL), ni)
    class_idx = rng.integers(0, len(_CLASSES), ni)
    manufact_id = rng.integers(1, 1000, ni)
    out["item"] = pa.table({
        "i_item_sk": i_sk.astype(np.int64),
        "i_item_id": _ids("I", ((i_sk - 1) // 2) * 2 + 1),  # pairs share ids
        "i_item_desc": np.asarray(
            [f"desc {w} of item {k % 997}" for k, w in
             zip(i_sk, _pick(rng, _STREET_NAMES, ni))], dtype=object),
        "i_current_price": _dec(rng, ni, 0.09, 99.99),
        "i_wholesale_cost": _dec(rng, ni, 0.05, 80.0),
        "i_brand_id": (brand_idx + 1001).astype(np.int32),
        "i_brand": np.asarray(_BRAND_POOL, dtype=object)[brand_idx],
        "i_class_id": (class_idx + 1).astype(np.int32),
        "i_class": np.asarray(_CLASSES, dtype=object)[class_idx],
        "i_category_id": (cat_idx + 1).astype(np.int32),
        "i_category": np.asarray(_CATEGORIES, dtype=object)[cat_idx],
        "i_manufact_id": manufact_id.astype(np.int32),
        "i_manufact": np.asarray(
            [f"manufact{m % 100}" for m in manufact_id], dtype=object),
        "i_size": _pick(rng, _SIZES, ni),
        "i_color": _pick(rng, _COLORS, ni),
        "i_units": _pick(rng, _UNITS, ni),
        "i_manager_id": rng.integers(1, 101, ni).astype(np.int32),
        "i_product_name": np.asarray(
            [f"product{k}" for k in i_sk], dtype=object),
    })

    # ---- customer_address -------------------------------------------------
    na = S(50000, 200)
    ca_sk = np.arange(1, na + 1)
    out["customer_address"] = pa.table({
        "ca_address_sk": ca_sk.astype(np.int64),
        "ca_address_id": _ids("A", ca_sk),
        "ca_street_number": np.asarray(
            [str(x) for x in rng.integers(1, 1000, na)], dtype=object),
        "ca_street_name": _pick(rng, _STREET_NAMES, na),
        "ca_street_type": _pick(rng, _STREET_TYPES, na),
        "ca_suite_number": np.asarray(
            [f"Suite {x}" for x in rng.integers(0, 500, na)], dtype=object),
        "ca_city": _pick(rng, _CITIES, na),
        "ca_county": _pick(rng, _COUNTIES, na),
        "ca_state": _pick(rng, _STATES, na),
        "ca_zip": np.asarray(
            [f"{z:05d}" for z in rng.integers(10000, 99999, na)],
            dtype=object),
        "ca_country": _pick(rng, _COUNTRIES, na),
        "ca_gmt_offset": rng.choice([-10.0, -9.0, -8.0, -7.0, -6.0, -5.0],
                                    na),
        "ca_location_type": _pick(
            rng, ["apartment", "condo", "single family"], na),
    })

    # ---- customer_demographics (fixed cross product, sampled) -------------
    ncd = 7200
    cd_sk = np.arange(1, ncd + 1)
    out["customer_demographics"] = pa.table({
        "cd_demo_sk": cd_sk.astype(np.int64),
        "cd_gender": np.asarray(_GENDERS, dtype=object)[cd_sk % 2],
        "cd_marital_status": np.asarray(_MARITAL, dtype=object)[cd_sk % 5],
        "cd_education_status": np.asarray(
            _EDUCATION, dtype=object)[cd_sk % 7],
        "cd_purchase_estimate": ((cd_sk % 20) * 500 + 500).astype(np.int32),
        "cd_credit_rating": np.asarray(
            _CREDIT_RATINGS, dtype=object)[cd_sk % 4],
        "cd_dep_count": (cd_sk % 7).astype(np.int32),
        "cd_dep_employed_count": (cd_sk % 7).astype(np.int32),
        "cd_dep_college_count": (cd_sk % 7).astype(np.int32),
    })

    # ---- household_demographics / income_band -----------------------------
    nib = 20
    out["income_band"] = pa.table({
        "ib_income_band_sk": np.arange(1, nib + 1, dtype=np.int64),
        "ib_lower_bound": (np.arange(nib) * 10000).astype(np.int32),
        "ib_upper_bound": ((np.arange(nib) + 1) * 10000).astype(np.int32),
    })
    nhd = 7200
    hd_sk = np.arange(1, nhd + 1)
    out["household_demographics"] = pa.table({
        "hd_demo_sk": hd_sk.astype(np.int64),
        "hd_income_band_sk": (hd_sk % nib + 1).astype(np.int64),
        "hd_buy_potential": np.asarray(
            _BUY_POTENTIAL, dtype=object)[hd_sk % 6],
        "hd_dep_count": (hd_sk % 10).astype(np.int32),
        "hd_vehicle_count": (hd_sk % 6).astype(np.int32),
    })

    # ---- customer ---------------------------------------------------------
    nc = S(100000, 500)
    c_sk = np.arange(1, nc + 1)
    out["customer"] = pa.table({
        "c_customer_sk": c_sk.astype(np.int64),
        "c_customer_id": _ids("C", c_sk),
        "c_current_cdemo_sk": rng.integers(1, ncd + 1, nc).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(1, nhd + 1, nc).astype(np.int64),
        "c_current_addr_sk": rng.integers(1, na + 1, nc).astype(np.int64),
        "c_first_shipto_date_sk": rng.integers(
            _SK0, _SK0 + nd, nc).astype(np.int64),
        "c_first_sales_date_sk": rng.integers(
            _SK0, _SK0 + nd, nc).astype(np.int64),
        "c_salutation": _pick(rng, _SALUTATIONS, nc),
        "c_first_name": _pick(rng, _FIRST_NAMES, nc),
        "c_last_name": _pick(rng, _LAST_NAMES, nc),
        "c_preferred_cust_flag": _pick(rng, ["Y", "N"], nc),
        "c_birth_day": rng.integers(1, 29, nc).astype(np.int32),
        "c_birth_month": rng.integers(1, 13, nc).astype(np.int32),
        "c_birth_year": rng.integers(1930, 1993, nc).astype(np.int32),
        "c_birth_country": _pick(
            rng, ["UNITED STATES", "CANADA", "MEXICO", "GERMANY", "JAPAN",
                  "FRANCE", "BRAZIL", "NIGERIA", "INDIA", "CHINA"], nc),
        "c_login": _pick(rng, [""], nc),
        "c_email_address": np.asarray(
            [f"user{k}@example.com" for k in c_sk], dtype=object),
        "c_last_review_date_sk": rng.integers(
            _SK0, _SK0 + nd, nc).astype(np.int64),
    })

    # ---- store ------------------------------------------------------------
    ns = max(2, int(12 * max(sf, 0.2)))
    s_sk = np.arange(1, ns + 1)
    out["store"] = pa.table({
        "s_store_sk": s_sk.astype(np.int64),
        "s_store_id": _ids("S", ((s_sk - 1) // 2) * 2 + 1),
        "s_store_name": np.asarray(
            ["ought", "able", "pri", "ese", "anti", "cally", "ation",
             "eing", "n st", "bar"][: max(ns, 1)] * (ns // 10 + 1),
            dtype=object)[:ns],
        "s_number_employees": rng.integers(200, 300, ns).astype(np.int32),
        "s_floor_space": rng.integers(5000000, 10000000, ns).astype(np.int32),
        "s_hours": _pick(rng, ["8AM-8AM", "8AM-4PM", "8AM-12AM"], ns),
        "s_manager": _pick(rng, _FIRST_NAMES, ns),
        "s_market_id": rng.integers(1, 11, ns).astype(np.int32),
        "s_company_id": np.ones(ns, dtype=np.int32),
        "s_company_name": _pick(rng, ["Unknown"], ns),
        "s_street_number": np.asarray(
            [str(x) for x in rng.integers(1, 1000, ns)], dtype=object),
        "s_street_name": _pick(rng, _STREET_NAMES, ns),
        "s_street_type": _pick(rng, _STREET_TYPES, ns),
        "s_suite_number": np.asarray(
            [f"Suite {x}" for x in rng.integers(0, 500, ns)], dtype=object),
        "s_city": _pick(rng, _CITIES, ns),
        "s_county": _pick(rng, _COUNTIES, ns),
        "s_state": _pick(rng, _STATES[:8], ns),
        "s_zip": np.asarray(
            [f"{z:05d}" for z in rng.integers(10000, 99999, ns)],
            dtype=object),
        "s_gmt_offset": rng.choice([-8.0, -7.0, -6.0, -5.0], ns),
        "s_tax_precentage": _dec(rng, ns, 0.0, 0.11),
    })

    # ---- call_center / catalog_page / web_site / web_page / warehouse -----
    ncc = max(2, int(6 * max(sf, 0.34)))
    cc_sk = np.arange(1, ncc + 1)
    out["call_center"] = pa.table({
        "cc_call_center_sk": cc_sk.astype(np.int64),
        "cc_call_center_id": _ids("CC", ((cc_sk - 1) // 2) * 2 + 1),
        "cc_name": np.asarray(
            [f"{n} center" for n in
             ["NY Metro", "Mid Atlantic", "North Midwest", "California",
              "Pacific Northwest", "South"][:ncc]], dtype=object),
        "cc_manager": _pick(rng, _FIRST_NAMES, ncc),
        "cc_county": _pick(rng, _COUNTIES, ncc),
    })
    ncp = S(11000, 50)
    cp_sk = np.arange(1, ncp + 1)
    out["catalog_page"] = pa.table({
        "cp_catalog_page_sk": cp_sk.astype(np.int64),
        "cp_catalog_page_id": _ids("CP", cp_sk),
    })
    nws = max(2, int(30 * max(sf, 0.1)))
    web_sk = np.arange(1, nws + 1)
    out["web_site"] = pa.table({
        "web_site_sk": web_sk.astype(np.int64),
        "web_site_id": _ids("W", ((web_sk - 1) // 2) * 2 + 1),
        "web_name": np.asarray(
            [f"site_{k % 8}" for k in web_sk], dtype=object),
        "web_company_name": _pick(
            rng, ["pri", "ought", "able", "ese", "anti", "cally"], nws),
    })
    nwp = S(60, 10)
    wp_sk = np.arange(1, nwp + 1)
    out["web_page"] = pa.table({
        "wp_web_page_sk": wp_sk.astype(np.int64),
        "wp_web_page_id": _ids("WP", wp_sk),
        "wp_char_count": rng.integers(100, 8000, nwp).astype(np.int32),
    })
    nw = max(2, int(5 * max(sf, 0.4)))
    w_sk = np.arange(1, nw + 1)
    out["warehouse"] = pa.table({
        "w_warehouse_sk": w_sk.astype(np.int64),
        "w_warehouse_id": _ids("WH", w_sk),
        "w_warehouse_name": np.asarray(
            [f"Warehouse number {k}" for k in w_sk], dtype=object),
        "w_warehouse_sq_ft": rng.integers(50000, 1000000, nw).astype(
            np.int32),
        "w_city": _pick(rng, _CITIES, nw),
        "w_county": _pick(rng, _COUNTIES, nw),
        "w_state": _pick(rng, _STATES[:8], nw),
        "w_country": _pick(rng, _COUNTRIES, nw),
    })

    # ---- promotion / reason / ship_mode -----------------------------------
    npr = S(300, 20)
    p_sk = np.arange(1, npr + 1)
    out["promotion"] = pa.table({
        "p_promo_sk": p_sk.astype(np.int64),
        "p_promo_id": _ids("P", p_sk),
        "p_channel_dmail": _pick(rng, ["Y", "N"], npr),
        "p_channel_email": _pick(rng, ["Y", "N"], npr),
        "p_channel_tv": _pick(rng, ["Y", "N"], npr),
        "p_channel_event": _pick(rng, ["Y", "N"], npr),
        "p_promo_name": _pick(
            rng, ["ought", "able", "pri", "ese", "anti"], npr),
    })
    nr = 35
    r_sk = np.arange(1, nr + 1)
    reasons = ["Package was damaged", "Stopped working", "Did not get it",
               "Not the product that was ordred", "Parts missing",
               "Does not work with a product that I have",
               "Gift exchange", "Did not like the color",
               "Did not like the model", "Did not like the make",
               "Did not like the warranty", "No service location in my area",
               "Found a better price in a store",
               "Found a better extended warranty in a store",
               "reason 15", "reason 16", "reason 17", "reason 18",
               "reason 19", "reason 20", "reason 21", "reason 22",
               "reason 23", "reason 24", "reason 25", "reason 26",
               "reason 27", "reason 28", "reason 29", "reason 30",
               "reason 31", "reason 32", "reason 33", "reason 34",
               "reason 35"]
    out["reason"] = pa.table({
        "r_reason_sk": r_sk.astype(np.int64),
        "r_reason_id": _ids("R", r_sk),
        "r_reason_desc": np.asarray(reasons, dtype=object),
    })
    nsm = 20
    sm_sk = np.arange(1, nsm + 1)
    out["ship_mode"] = pa.table({
        "sm_ship_mode_sk": sm_sk.astype(np.int64),
        "sm_ship_mode_id": _ids("SM", sm_sk),
        "sm_type": np.asarray(
            [_SHIP_TYPES[i % len(_SHIP_TYPES)] for i in range(nsm)],
            dtype=object),
        "sm_code": _pick(rng, ["AIR", "SURFACE", "SEA"], nsm),
        "sm_carrier": np.asarray(_SHIP_CARRIERS, dtype=object)[:nsm],
    })

    # ---- fact: store_sales + store_returns --------------------------------
    nss = S(2_880_000, 2000)
    ticket = rng.integers(1, max(nss // 3, 2), nss)
    ss = {
        "ss_sold_date_sk": rng.integers(_SK0, _SK0 + nd, nss),
        "ss_sold_time_sk": rng.integers(0, nt, nss),
        "ss_item_sk": rng.integers(1, ni + 1, nss),
        "ss_customer_sk": rng.integers(1, nc + 1, nss),
        "ss_cdemo_sk": rng.integers(1, ncd + 1, nss),
        "ss_hdemo_sk": rng.integers(1, nhd + 1, nss),
        "ss_addr_sk": rng.integers(1, na + 1, nss),
        "ss_store_sk": rng.integers(1, ns + 1, nss),
        "ss_promo_sk": rng.integers(1, npr + 1, nss),
        "ss_ticket_number": ticket,
        "ss_quantity": rng.integers(1, 101, nss),
        "ss_wholesale_cost": _dec(rng, nss, 1.0, 100.0),
        "ss_list_price": _dec(rng, nss, 1.0, 200.0),
        "ss_sales_price": _dec(rng, nss, 0.0, 200.0),
        "ss_ext_discount_amt": _dec(rng, nss, 0.0, 1000.0),
        "ss_ext_sales_price": _dec(rng, nss, 0.0, 2000.0),
        "ss_ext_wholesale_cost": _dec(rng, nss, 1.0, 2000.0),
        "ss_ext_list_price": _dec(rng, nss, 1.0, 4000.0),
        "ss_ext_tax": _dec(rng, nss, 0.0, 200.0),
        "ss_coupon_amt": _dec(rng, nss, 0.0, 500.0),
        "ss_net_paid": _dec(rng, nss, 0.0, 2000.0),
        "ss_net_paid_inc_tax": _dec(rng, nss, 0.0, 2200.0),
        "ss_net_profit": _dec(rng, nss, -1000.0, 1000.0),
    }
    # nullable customer FK (queries LEFT JOIN / IS NULL on it)
    null_mask = rng.random(nss) < 0.04
    cols = {
        k: (pa.array(v, type=pa.int64(), mask=null_mask)
            if k == "ss_customer_sk" else v)
        for k, v in ss.items()
    }
    out["store_sales"] = pa.table(cols)

    nsr = max(200, nss // 10)
    ridx = rng.integers(0, nss, nsr)
    out["store_returns"] = pa.table({
        "sr_returned_date_sk": np.minimum(
            ss["ss_sold_date_sk"][ridx] + rng.integers(1, 60, nsr),
            _SK0 + nd - 1),
        "sr_return_time_sk": rng.integers(0, nt, nsr),
        "sr_item_sk": ss["ss_item_sk"][ridx],
        "sr_customer_sk": ss["ss_customer_sk"][ridx],
        "sr_cdemo_sk": ss["ss_cdemo_sk"][ridx],
        "sr_hdemo_sk": ss["ss_hdemo_sk"][ridx],
        "sr_addr_sk": ss["ss_addr_sk"][ridx],
        "sr_store_sk": ss["ss_store_sk"][ridx],
        "sr_reason_sk": rng.integers(1, nr + 1, nsr),
        "sr_ticket_number": ss["ss_ticket_number"][ridx],
        "sr_return_quantity": rng.integers(1, 50, nsr),
        "sr_return_amt": _dec(rng, nsr, 0.0, 1000.0),
        "sr_return_tax": _dec(rng, nsr, 0.0, 100.0),
        "sr_return_amt_inc_tax": _dec(rng, nsr, 0.0, 1100.0),
        "sr_fee": _dec(rng, nsr, 0.0, 100.0),
        "sr_return_ship_cost": _dec(rng, nsr, 0.0, 500.0),
        "sr_refunded_cash": _dec(rng, nsr, 0.0, 1000.0),
        "sr_reversed_charge": _dec(rng, nsr, 0.0, 1000.0),
        "sr_store_credit": _dec(rng, nsr, 0.0, 1000.0),
        "sr_net_loss": _dec(rng, nsr, 0.0, 1000.0),
    })

    # ---- fact: catalog_sales + catalog_returns ----------------------------
    ncs = S(1_440_000, 1000)
    order = rng.integers(1, max(ncs // 3, 2), ncs)
    cs = {
        "cs_sold_date_sk": rng.integers(_SK0, _SK0 + nd, ncs),
        "cs_sold_time_sk": rng.integers(0, nt, ncs),
        "cs_ship_date_sk": None,  # filled below
        "cs_bill_customer_sk": rng.integers(1, nc + 1, ncs),
        "cs_bill_cdemo_sk": rng.integers(1, ncd + 1, ncs),
        "cs_bill_hdemo_sk": rng.integers(1, nhd + 1, ncs),
        "cs_bill_addr_sk": rng.integers(1, na + 1, ncs),
        "cs_ship_customer_sk": rng.integers(1, nc + 1, ncs),
        "cs_ship_addr_sk": rng.integers(1, na + 1, ncs),
        "cs_call_center_sk": rng.integers(1, ncc + 1, ncs),
        "cs_catalog_page_sk": rng.integers(1, ncp + 1, ncs),
        "cs_ship_mode_sk": rng.integers(1, nsm + 1, ncs),
        "cs_warehouse_sk": rng.integers(1, nw + 1, ncs),
        "cs_item_sk": rng.integers(1, ni + 1, ncs),
        "cs_promo_sk": rng.integers(1, npr + 1, ncs),
        "cs_order_number": order,
        "cs_quantity": rng.integers(1, 101, ncs),
        "cs_wholesale_cost": _dec(rng, ncs, 1.0, 100.0),
        "cs_list_price": _dec(rng, ncs, 1.0, 300.0),
        "cs_sales_price": _dec(rng, ncs, 0.0, 300.0),
        "cs_ext_discount_amt": _dec(rng, ncs, 0.0, 1000.0),
        "cs_ext_sales_price": _dec(rng, ncs, 0.0, 3000.0),
        "cs_ext_wholesale_cost": _dec(rng, ncs, 1.0, 2000.0),
        "cs_ext_list_price": _dec(rng, ncs, 1.0, 6000.0),
        "cs_ext_tax": _dec(rng, ncs, 0.0, 300.0),
        "cs_coupon_amt": _dec(rng, ncs, 0.0, 500.0),
        "cs_ext_ship_cost": _dec(rng, ncs, 0.0, 500.0),
        "cs_net_paid": _dec(rng, ncs, 0.0, 3000.0),
        "cs_net_paid_inc_tax": _dec(rng, ncs, 0.0, 3300.0),
        "cs_net_paid_inc_ship": _dec(rng, ncs, 0.0, 3500.0),
        "cs_net_paid_inc_ship_tax": _dec(rng, ncs, 0.0, 3800.0),
        "cs_net_profit": _dec(rng, ncs, -1000.0, 1500.0),
    }
    cs["cs_ship_date_sk"] = np.minimum(
        cs["cs_sold_date_sk"] + rng.integers(1, 120, ncs), _SK0 + nd - 1
    )
    out["catalog_sales"] = pa.table(cs)

    ncr = max(150, ncs // 10)
    ridx = rng.integers(0, ncs, ncr)
    out["catalog_returns"] = pa.table({
        "cr_returned_date_sk": np.minimum(
            cs["cs_ship_date_sk"][ridx] + rng.integers(1, 60, ncr),
            _SK0 + nd - 1),
        "cr_returned_time_sk": rng.integers(0, nt, ncr),
        "cr_item_sk": cs["cs_item_sk"][ridx],
        "cr_refunded_customer_sk": cs["cs_bill_customer_sk"][ridx],
        "cr_refunded_cdemo_sk": cs["cs_bill_cdemo_sk"][ridx],
        "cr_refunded_addr_sk": cs["cs_bill_addr_sk"][ridx],
        "cr_returning_customer_sk": cs["cs_ship_customer_sk"][ridx],
        "cr_returning_cdemo_sk": cs["cs_bill_cdemo_sk"][ridx],
        "cr_returning_addr_sk": cs["cs_ship_addr_sk"][ridx],
        "cr_call_center_sk": cs["cs_call_center_sk"][ridx],
        "cr_catalog_page_sk": cs["cs_catalog_page_sk"][ridx],
        "cr_ship_mode_sk": cs["cs_ship_mode_sk"][ridx],
        "cr_warehouse_sk": cs["cs_warehouse_sk"][ridx],
        "cr_reason_sk": rng.integers(1, nr + 1, ncr),
        "cr_order_number": cs["cs_order_number"][ridx],
        "cr_return_quantity": rng.integers(1, 50, ncr),
        "cr_return_amount": _dec(rng, ncr, 0.0, 1500.0),
        "cr_return_tax": _dec(rng, ncr, 0.0, 150.0),
        "cr_return_amt_inc_tax": _dec(rng, ncr, 0.0, 1650.0),
        "cr_fee": _dec(rng, ncr, 0.0, 100.0),
        "cr_return_ship_cost": _dec(rng, ncr, 0.0, 500.0),
        "cr_refunded_cash": _dec(rng, ncr, 0.0, 1500.0),
        "cr_reversed_charge": _dec(rng, ncr, 0.0, 1500.0),
        "cr_store_credit": _dec(rng, ncr, 0.0, 1500.0),
        "cr_net_loss": _dec(rng, ncr, 0.0, 1500.0),
    })

    # ---- fact: web_sales + web_returns ------------------------------------
    nwsales = S(720_000, 600)
    worder = rng.integers(1, max(nwsales // 3, 2), nwsales)
    ws = {
        "ws_sold_date_sk": rng.integers(_SK0, _SK0 + nd, nwsales),
        "ws_sold_time_sk": rng.integers(0, nt, nwsales),
        "ws_ship_date_sk": None,
        "ws_item_sk": rng.integers(1, ni + 1, nwsales),
        "ws_bill_customer_sk": rng.integers(1, nc + 1, nwsales),
        "ws_bill_cdemo_sk": rng.integers(1, ncd + 1, nwsales),
        "ws_bill_hdemo_sk": rng.integers(1, nhd + 1, nwsales),
        "ws_bill_addr_sk": rng.integers(1, na + 1, nwsales),
        "ws_ship_customer_sk": rng.integers(1, nc + 1, nwsales),
        "ws_ship_cdemo_sk": rng.integers(1, ncd + 1, nwsales),
        "ws_ship_hdemo_sk": rng.integers(1, nhd + 1, nwsales),
        "ws_ship_addr_sk": rng.integers(1, na + 1, nwsales),
        "ws_web_page_sk": rng.integers(1, nwp + 1, nwsales),
        "ws_web_site_sk": rng.integers(1, nws + 1, nwsales),
        "ws_ship_mode_sk": rng.integers(1, nsm + 1, nwsales),
        "ws_warehouse_sk": rng.integers(1, nw + 1, nwsales),
        "ws_promo_sk": rng.integers(1, npr + 1, nwsales),
        "ws_order_number": worder,
        "ws_quantity": rng.integers(1, 101, nwsales),
        "ws_wholesale_cost": _dec(rng, nwsales, 1.0, 100.0),
        "ws_list_price": _dec(rng, nwsales, 1.0, 300.0),
        "ws_sales_price": _dec(rng, nwsales, 0.0, 300.0),
        "ws_ext_discount_amt": _dec(rng, nwsales, 0.0, 1000.0),
        "ws_ext_sales_price": _dec(rng, nwsales, 0.0, 3000.0),
        "ws_ext_wholesale_cost": _dec(rng, nwsales, 1.0, 2000.0),
        "ws_ext_list_price": _dec(rng, nwsales, 1.0, 6000.0),
        "ws_ext_tax": _dec(rng, nwsales, 0.0, 300.0),
        "ws_coupon_amt": _dec(rng, nwsales, 0.0, 500.0),
        "ws_ext_ship_cost": _dec(rng, nwsales, 0.0, 500.0),
        "ws_net_paid": _dec(rng, nwsales, 0.0, 3000.0),
        "ws_net_paid_inc_tax": _dec(rng, nwsales, 0.0, 3300.0),
        "ws_net_profit": _dec(rng, nwsales, -1000.0, 1500.0),
    }
    ws["ws_ship_date_sk"] = np.minimum(
        ws["ws_sold_date_sk"] + rng.integers(1, 120, nwsales), _SK0 + nd - 1
    )
    out["web_sales"] = pa.table(ws)

    nwr = max(100, nwsales // 10)
    ridx = rng.integers(0, nwsales, nwr)
    out["web_returns"] = pa.table({
        "wr_returned_date_sk": np.minimum(
            ws["ws_ship_date_sk"][ridx] + rng.integers(1, 60, nwr),
            _SK0 + nd - 1),
        "wr_returned_time_sk": rng.integers(0, nt, nwr),
        "wr_item_sk": ws["ws_item_sk"][ridx],
        "wr_refunded_customer_sk": ws["ws_bill_customer_sk"][ridx],
        "wr_refunded_cdemo_sk": ws["ws_bill_cdemo_sk"][ridx],
        "wr_refunded_hdemo_sk": ws["ws_bill_hdemo_sk"][ridx],
        "wr_refunded_addr_sk": ws["ws_bill_addr_sk"][ridx],
        "wr_returning_customer_sk": ws["ws_ship_customer_sk"][ridx],
        "wr_returning_cdemo_sk": ws["ws_ship_cdemo_sk"][ridx],
        "wr_returning_hdemo_sk": ws["ws_ship_hdemo_sk"][ridx],
        "wr_returning_addr_sk": ws["ws_ship_addr_sk"][ridx],
        "wr_web_page_sk": ws["ws_web_page_sk"][ridx],
        "wr_reason_sk": rng.integers(1, nr + 1, nwr),
        "wr_order_number": ws["ws_order_number"][ridx],
        "wr_return_quantity": rng.integers(1, 50, nwr),
        "wr_return_amt": _dec(rng, nwr, 0.0, 1500.0),
        "wr_return_tax": _dec(rng, nwr, 0.0, 150.0),
        "wr_return_amt_inc_tax": _dec(rng, nwr, 0.0, 1650.0),
        "wr_fee": _dec(rng, nwr, 0.0, 100.0),
        "wr_return_ship_cost": _dec(rng, nwr, 0.0, 500.0),
        "wr_refunded_cash": _dec(rng, nwr, 0.0, 1500.0),
        "wr_reversed_charge": _dec(rng, nwr, 0.0, 1500.0),
        "wr_account_credit": _dec(rng, nwr, 0.0, 1500.0),
        "wr_net_loss": _dec(rng, nwr, 0.0, 1500.0),
    })

    # ---- fact: inventory (weekly snapshots) -------------------------------
    weeks = np.arange(_SK0, _SK0 + nd, 7)
    ninv_items = min(ni, S(2000, 200))
    inv_date = np.repeat(weeks, ninv_items * nw)
    inv_item = np.tile(np.repeat(np.arange(1, ninv_items + 1), nw),
                       len(weeks))
    inv_wh = np.tile(np.arange(1, nw + 1), len(weeks) * ninv_items)
    out["inventory"] = pa.table({
        "inv_date_sk": inv_date.astype(np.int64),
        "inv_item_sk": inv_item.astype(np.int64),
        "inv_warehouse_sk": inv_wh.astype(np.int64),
        "inv_quantity_on_hand": rng.integers(
            0, 1000, len(inv_date)).astype(np.int32),
    })

    return out


def register_tpcds(ctx, sf: float = 0.01, seed: int = 0) -> dict:
    """Generate and register all TPC-DS tables on a SessionContext (on its
    device) -> the Arrow tables."""
    tables = gen_tpcds(sf=sf, seed=seed)
    for name, arrow in tables.items():
        ctx.register_arrow(name, arrow)
    return tables
