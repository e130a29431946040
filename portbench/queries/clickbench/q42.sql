SELECT date_trunc('minute', to_timestamp_seconds("EventTime")) AS m,
       COUNT(*) AS c
FROM hits
WHERE "CounterID" = 62 AND "EventDate" >= date '2013-07-01'
  AND "EventDate" <= date '2013-07-02' AND "IsRefresh" = 0
  AND "DontCountHits" = 0
GROUP BY m ORDER BY m LIMIT 10
